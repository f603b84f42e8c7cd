// Inverse FFT from the weighted half spectrum over a window of k1 rows,
// with two epilogues: the overlap-add (replaces folve_tpu ifft_half.py
// pallas_ifft_ola) and a plain store of the window's partial inverse
// (replaces pallas_ifft_partial_rows and, over all rows,
// pallas_ifft_from_half).
//
// Bound on the H100: bytes (each signal reads 2*k1_n*cols floats and
// writes n; an FFT is ~6 FLOP per byte, below the fp32 balance).  One
// block per signal runs the inverse as radix FFTs (radix::inverse in
// fft_radix.cuh, the body the fused step in conv_step.cu shares) with the
// complex [m1, m2] intermediate in shared memory (132 KB at n = 16384:
// one 512-thread block per SM), so device memory sees each input once
// and each output once: this kernel loads the window's rows
// Y[k1, c] * wn[k1, c] (multiplicity / n) into shared memory, coalesced,
// and the body runs the rest.  This is the function of the dense stages
// of engine/rfft.py over the same weighted rectangle and window, so a
// window gives its shard's partial and the partials of windows that tile
// the m1 rows sum to the whole inverse.
//
// The overlap-add epilogue (radix::OlaStore): the TPU kernel carries the
// overlap tail across a sequential t grid; here blocks run in no order,
// so each block adds its head half into y[t] and its tail half into
// y[t+1] with atomicAdd, into an output the wrapper pre-sets to
// (tail_in, 0, ..., 0); deterministic, as the note there says.  This
// keeps all S*T*C blocks in flight.
#include "fft_radix.cuh"

using folve::Plan;
namespace radix = folve::radix;

namespace {

// Overlap-add: grid (T*C, S); the block's inverse goes through
// radix::OlaStore into y[t] and y[t+1] (the new tail at the last t).
struct OlaEpilogue {
  float* y;
  float* new_tail;
  int T, C, B;
  __device__ long row() const {
    return ((long)blockIdx.y * T + blockIdx.x / C) * C + blockIdx.x % C;
  }
  __device__ radix::OlaStore at(long row) const {
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
  constexpr int LD = S::LD, NT = S::THREADS, COLS = S::COLS;
  extern __shared__ float smem[];
  float2* sm = reinterpret_cast<float2*>(smem);  // [M1][LD] complex
  const long row = epi.row();
  const long K = (long)k1_n * COLS;
  const float* ar = yr + row * K;
  const float* ai = yi + row * K;
  // The weighted window rows, row kk at kk*LD, columns c < cols.
  for (int i = threadIdx.x; i < K; i += NT) {
    const int kk = i / COLS, c = i - kk * COLS;
    const float w = __ldg(P.wn + k1_start * COLS + i);
    sm[kk * LD + c] = make_float2(ar[i] * w, ai[i] * w);
  }
  __syncthreads();
  radix::inverse<M1, M2>(sm, P, k1_start, k1_n, [&] { return epi.at(row); });
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
