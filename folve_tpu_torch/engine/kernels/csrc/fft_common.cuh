// The packed plan (Plan, make_plan), read by every FFT kernel, and the
// dense matmul-DFT helpers (fwd_row, inv_row, inv_stage2*), which serve
// the fused conv-step kernel (conv_step.cu) alone: the forward and inverse
// kernels run radix FFTs (fft_radix.cuh).
//
// In the dense helpers the transform of size n = m1*m2 runs as two dense
// stages (Cooley-Tukey, see engine/rfft.py) in plain fp32 FMA on the CUDA
// cores: no TF32 and no bf16 split, so the kernel tracks the float32
// reference to ~1e-6 relative.  n <= 16384 (fragm <= MAXQUANT = 8192), so m1, m2 <= 128 and
// m1 >= m2.  The DFT factor matrices are symmetric (outer(k, k)), which
// lets every stage read them row-major with neighbouring lanes on
// neighbouring columns.
#pragma once

#include <cuda_runtime.h>

namespace folve {

// Plan factors in one packed fp32 buffer (engine/rfft.py PlanTensors):
// f1_re, f1_im [m1, m1]; tw_re, tw_im [m1, m2]; f2_re, f2_im [m2, m2];
// wn [m1, cols] = half-spectrum multiplicity / n.
struct Plan {
  const float* f1r;
  const float* f1i;
  const float* twr;
  const float* twi;
  const float* f2r;
  const float* f2i;
  const float* wn;
  int m1, m2, cols;
};

inline Plan make_plan(const float* packed, int m1, int m2) {
  Plan p;
  p.m1 = m1;
  p.m2 = m2;
  p.cols = m2 / 2 + 1;
  p.f1r = packed;
  p.f1i = p.f1r + m1 * m1;
  p.twr = p.f1i + m1 * m1;
  p.twi = p.twr + m1 * m2;
  p.f2r = p.twi + m1 * m2;
  p.f2i = p.f2r + m2 * m2;
  p.wn = p.f2i + m2 * m2;
  return p;
}

// Threads of a block that runs inv_stage2, and the output rows each
// thread accumulates there: n / kBlockThreads <= kMaxJ for n <= 16384.
constexpr int kBlockThreads = 512;
constexpr int kMaxJ = 32;

// One warp: row k1 of the permuted half spectrum of a real block.
// A: shared [rows][m2], the block's non-zero rows (zero padding to n is
// implicit: stage 1 contracts only these rows).  trow: this warp's
// shared scratch of 2*m2 floats.  store(c, re, im) receives X[k1, c] for
// c < cols.
template <class Store>
__device__ __forceinline__ void fwd_row(const Plan& P, const float* A,
                                        int rows, int k1, float* trow,
                                        Store store) {
  const int lane = threadIdx.x & 31;
  const int m1 = P.m1, m2 = P.m2;
  for (int b = lane; b < m2; b += 32) {
    float sr = 0.f, si = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float a = A[r * m2 + b];
      sr = fmaf(__ldg(P.f1r + k1 * m1 + r), a, sr);
      si = fmaf(__ldg(P.f1i + k1 * m1 + r), a, si);
    }
    const float tr = __ldg(P.twr + k1 * m2 + b);
    const float ti = __ldg(P.twi + k1 * m2 + b);
    trow[b] = sr * tr - si * ti;
    trow[m2 + b] = sr * ti + si * tr;
  }
  __syncwarp();
  for (int c = lane; c < P.cols; c += 32) {
    float xr = 0.f, xi = 0.f;
    for (int b = 0; b < m2; ++b) {
      const float t_r = trow[b], t_i = trow[m2 + b];
      const float fr = __ldg(P.f2r + b * m2 + c);
      const float fi = __ldg(P.f2i + b * m2 + c);
      xr = fmaf(t_r, fr, xr);
      xr = fmaf(-t_i, fi, xr);
      xi = fmaf(t_r, fi, xi);
      xi = fmaf(t_i, fr, xi);
    }
    store(c, xr, xi);
  }
  __syncwarp();
}

// One warp: stage 1 of the inverse plus the conjugate twiddle for row
// k1.  load(c, re, im) gives the weighted half-spectrum value
// Y[k1, c] * wn[k1, c].  Writes V[k1, :] into Vr/Vi (shared [m1][m2]).
template <class Load>
__device__ __forceinline__ void inv_row(const Plan& P, int k1, float* trow,
                                        Load load, float* Vr, float* Vi) {
  const int lane = threadIdx.x & 31;
  const int m2 = P.m2, cols = P.cols;
  for (int c = lane; c < cols; c += 32) {
    float re, im;
    load(c, re, im);
    trow[c] = re;
    trow[cols + c] = im;
  }
  __syncwarp();
  for (int b = lane; b < m2; b += 32) {
    float ur = 0.f, ui = 0.f;
    for (int c = 0; c < cols; ++c) {
      const float ar = trow[c], ai = trow[cols + c];
      const float fr = __ldg(P.f2r + c * m2 + b);
      const float fi = __ldg(P.f2i + c * m2 + b);
      ur = fmaf(ar, fr, ur);
      ur = fmaf(ai, fi, ur);
      ui = fmaf(ai, fr, ui);
      ui = fmaf(-ar, fi, ui);
    }
    const float tr = __ldg(P.twr + k1 * m2 + b);
    const float ti = __ldg(P.twi + k1 * m2 + b);
    Vr[k1 * m2 + b] = ur * tr + ui * ti;
    Vi[k1 * m2 + b] = ui * tr - ur * ti;
  }
  __syncwarp();
}

// Whole block of kBlockThreads: stage 2 of the inverse over the k1 rows
// [k1_begin, k1_end) of V, real part only.  Thread (g, b) with
// b = tid % m2 accumulates x[n1, b] for n1 = g + j*G (G = kBlockThreads /
// m2) into acc[j].  A window of rows gives a frequency shard's partial
// sum; the windows of all shards add up to the whole inverse.
__device__ __forceinline__ void inv_stage2_rows(const Plan& P, const float* Vr,
                                                const float* Vi, int k1_begin,
                                                int k1_end,
                                                float (&acc)[kMaxJ]) {
  const int m1 = P.m1, m2 = P.m2;
  const int b = threadIdx.x % m2, g = threadIdx.x / m2;
  const int G = kBlockThreads / m2;
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) acc[j] = 0.f;
  for (int k1 = k1_begin; k1 < k1_end; ++k1) {
    const float vr = Vr[k1 * m2 + b], vi = Vi[k1 * m2 + b];
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int n1 = g + j * G;
      if (n1 < m1) {
        acc[j] = fmaf(__ldg(P.f1r + n1 * m1 + k1), vr, acc[j]);
        acc[j] = fmaf(__ldg(P.f1i + n1 * m1 + k1), vi, acc[j]);
      }
    }
  }
}

// Stage 2 over every k1 row: the whole inverse.
__device__ __forceinline__ void inv_stage2(const Plan& P, const float* Vr,
                                           const float* Vi,
                                           float (&acc)[kMaxJ]) {
  inv_stage2_rows(P, Vr, Vi, 0, P.m1, acc);
}

}  // namespace folve
