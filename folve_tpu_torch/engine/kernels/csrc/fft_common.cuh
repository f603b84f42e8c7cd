// The packed plan (Plan, make_plan) that every FFT kernel reads: the DFT
// factors of the four-step split n = m1*m2 (engine/rfft.py), whose row 1
// holds the twiddles W_m^j of the radix FFTs (fft_radix.cuh), the table
// W_n^{k1*n2}, and the half-spectrum weights.  n <= 16384 (fragm <=
// MAXQUANT = 8192), so m1, m2 <= 128 and m1 >= m2.
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

}  // namespace folve
