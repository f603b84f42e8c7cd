// Frequency-delay-line MAC (kernels of engine/kernels/fdl_mac.py):
//   folve_fdl_mac_split  replaces folve_tpu fdl_mac.py pallas_fdl_mac_split
//                        (history and new spectra as two inputs, no concat);
//   folve_fdl_mac        replaces pallas_fdl_mac (one concatenated window:
//                        P = 1, and deep FDLs with min(P, T) > 32).
//
//   Y[s, t, o] = sum_p sum_i H[s|., p, i, o] * W[s, t + P-1 - p, i]
//
// complex, in fp32, bins in canonical order; H [P, Cin, Cout, 2, K] shared
// or [S, P, ...] per stream, Cin*Cout <= 16.  Window row w is hist[w] for
// w < P-1, else x[w - (P-1)] (split), or xall[w] (window).  Both entry
// points run one tile body, mac_kernel<Rows>; the Rows loader that finds
// a window row is their only difference.
//
// Bound on the H100.  A complex term is 8 FLOP; the function reads H and
// the window once and writes Y once.  A deep filter (P = 128, T = 64, one
// stream, Cin = Cout = 2) is bound by operations: 2.2 GFLOP, 0.033 ms at
// 67 TFLOP/s fp32.  The flagship's serving batch (P = 16, T = 8, eight
// streams with their own H: 67 MB) and P = 1 (17 MB) are bound by bytes.
//
// Design.  Per bin the MAC is a (T x P*Cin) Toeplitz times (P*Cin x Cout)
// product: each H value serves T blocks, each window value Cout outputs
// and up to P steps.  A block takes a tile of 32*bg bins and a group of
// sg streams and cg chunks of 8 blocks t; a warp owns (stream, o, chunk,
// 32 bins), one bin per lane, and keeps its 8 complex sums in registers.
// Per input channel and pass of at most pc partitions the block stages
// H's tile [np][Cout][32*bg] (step k holds partition p0 + np-1 - k) and
// the window rows [sg][8*cg + np][32*bg] as float2 in dynamic shared
// memory with cp.async (the copy holds no registers), then every warp
// walks the pass's steps: step k reads one H value and one new window
// row, and the 8 rows a step needs slide through registers, so 32 FMAs
// cost two shared loads.  A block stages each H value of its tile once,
// so H is read once per group of streams and chunks: once per call for
// the deep filter and the flagship's batches, shared or per stream.
// Where the streams of a shared H fall into several groups (P = 1, a
// freq shard's bins), the groups' blocks of one tile are neighbours on
// the grid's x dimension, so the re-reads find H's tile in L2.
//
// Per-stream H (a mixed batch; serve_short's two-filter batch): a block
// takes one stream (sg = 1; the streams sit on the grid's x dimension
// beside the chunk groups) and a wider bin tile instead (bg > 1);
// staging one H tile per stream of a group would give no more reuse for
// more shared memory.  At the flagship (Cout = 2, T = 8) a block is 4
// tiles of 32 bins x 2 outputs: 520 blocks of 256 threads, four per SM.
//
// Layout (mac_layout): at most 16 warps a block (two blocks of 512
// threads at 64 registers a thread share an SM) and 7 KB of staging a
// warp (two full blocks take 224 KB of the SM's 228).  Chunks fill the
// warps first, as they share H's tile and most window rows; then streams,
// where they share H and its tile outweighs a stream's window rows (not
// at P = 1); then at most 4 bin sub-tiles, which share nothing but the
// block's barriers: a smaller block lets one block's staging overlap
// another's arithmetic, and the memory-bound shapes ran faster so on the
// H100.  While the grid has fewer blocks than the card has SMs (a freq
// shard's 2,080 bins), the warps per block halve.  pc is the largest
// multiple of 8 whose staging fits, so P = 128 at T = 64 and P = 16 stage
// in one pass.
//
// Edges: a pass's steps end at its last partition (no zero H is staged
// or multiplied); window rows past T + P-2 are zero, and the tail chunk's
// sums past T are not stored; bins past K load bin K-1 and are not
// stored; P = 1 is one pass of one step.  Offsets are 64-bit.
//
// Precision: fp32 FMA on the CUDA cores, no TF32 and no tensor cores:
// Cout <= 16 is too narrow an N for wgmma to pay, and single-pass TF32
// cannot hold the engine's -90 dB.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kLane = 32;               // bins of a warp, one per lane
constexpr int kTBlocks = 8;             // blocks t a warp accumulates
constexpr int kMaxWarps = 16;           // warps of a block
constexpr int kMaxBins = 4;             // bin sub-tiles of a block
constexpr int kSmemPerWarp = 7 * 1024;  // staging bytes per warp

// A block's shape: sg streams, cg chunks of kTBlocks blocks t, bg
// sub-tiles of kLane bins, and at most pc partitions staged per pass.
struct MacLayout {
  int sg, cg, bg, pc;
};

int cdiv(int a, int b) { return (a + b - 1) / b; }

size_t mac_smem(const MacLayout& L, int Cout) {
  return (size_t)(L.pc * Cout + L.sg * (L.cg * kTBlocks + L.pc)) * L.bg *
         kLane * sizeof(float2);
}

MacLayout mac_layout(int S, int P, int Cout, int T, int K, bool shared,
                     int sms) {
  const int nch = cdiv(T, kTBlocks), tiles = cdiv(K, kLane);
  MacLayout L{1, 1, 1, kTBlocks};
  for (int w = kMaxWarps;; w /= 2) {
    L.cg = std::min(nch, std::max(1, w / Cout));
    // Streams share a block only where their common H tile outweighs a
    // stream's window rows (not at P = 1, where H is one row).
    const bool group = shared && P * Cout > L.cg * kTBlocks + P;
    L.sg = group ? std::min(S, std::max(1, w / (Cout * L.cg))) : 1;
    L.bg = std::min({tiles, kMaxBins, std::max(1, w / (Cout * L.cg * L.sg))});
    const long blocks =
        (long)cdiv(S, L.sg) * cdiv(nch, L.cg) * cdiv(tiles, L.bg);
    if (blocks >= sms || w <= Cout) break;
  }
  const size_t budget = (size_t)L.sg * Cout * L.cg * L.bg * kSmemPerWarp;
  while (L.pc < P) {
    MacLayout wider = L;
    wider.pc += kTBlocks;
    if (mac_smem(wider, Cout) > budget) break;
    L = wider;
  }
  return L;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess)
      n = v;
  }
  return n > 0 ? n : 132;
}

// One 4-byte copy from device to shared memory that holds no register
// until it lands; cp_async_wait() waits for all of this thread's.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Window rows of the split MAC: hist [S, P-1, Cin, K] for w < P-1, then
// x [S, T, Cin, K]; re and im are separate planes.
struct SplitRows {
  const float *hist_re, *hist_im, *xr, *xi;
  int P, T, Cin, K;
  __device__ int count() const { return T + P - 1; }
  __device__ void row(int s, int w, int i, const float*& re,
                      const float*& im) const {
    const int pm1 = P - 1;
    const long off = w < pm1 ? (((long)s * pm1 + w) * Cin + i) * K
                             : (((long)s * T + (w - pm1)) * Cin + i) * K;
    re = (w < pm1 ? hist_re : xr) + off;
    im = (w < pm1 ? hist_im : xi) + off;
  }
};

// Window rows of the window MAC: xall [S, W, Cin, K].
struct WindowRows {
  const float *xr, *xi;
  int W, Cin, K;
  __device__ int count() const { return W; }
  __device__ void row(int s, int w, int i, const float*& re,
                      const float*& im) const {
    const long off = (((long)s * W + w) * Cin + i) * K;
    re = xr + off;
    im = xi + off;
  }
};

// Block (group, tile): group = stream group * chunk groups + chunk group,
// tile = bins [tile * 32*bg, (tile + 1) * 32*bg).  Shared memory per pass
// (input channel i, partitions p0 .. p0 + np - 1): hs [np][Cout][tb], then
// ws [ns][nr][tb] with local row r = window row wbase + r.
template <class Rows>
__global__ void __launch_bounds__(kMaxWarps * kLane, 2)
    mac_kernel(const float* __restrict__ h, long h_stride, Rows rows,
               float* __restrict__ yr, float* __restrict__ yi, int S, int P,
               int Cin, int Cout, int T, int K, MacLayout L) {
  constexpr int TT = kTBlocks;
  extern __shared__ float smem[];
  const int tb = L.bg * kLane;
  float2* hs = reinterpret_cast<float2*>(smem);
  float2* ws = hs + L.pc * Cout * tb;
  const int lane = threadIdx.x % kLane, warp = threadIdx.x / kLane;
  const int nw = blockDim.x / kLane;
  const int nch = (T + TT - 1) / TT, ncg = (nch + L.cg - 1) / L.cg;
  const int s0 = blockIdx.x / ncg * L.sg, c0 = blockIdx.x % ncg * L.cg;
  const int ns = min(L.sg, S - s0), ncc = min(L.cg, nch - c0);
  const int bin0 = blockIdx.y * tb, W = rows.count();
  // This warp's unit: stream s0 + us, output o, blocks (c0 + uc)*TT + j,
  // bin bin0 + sub.
  const int ub = warp % L.bg, uc = warp / L.bg % L.cg;
  const int o = warp / (L.bg * L.cg) % Cout, us = warp / (L.bg * L.cg * Cout);
  const bool unit = us < ns && uc < ncc;
  const int sub = ub * kLane + lane;
  const float* hb = h + s0 * h_stride;
  float2 acc[TT];
#pragma unroll
  for (int j = 0; j < TT; ++j) acc[j] = make_float2(0.f, 0.f);

  for (int i = 0; i < Cin; ++i) {
    for (int p0 = 0; p0 < P; p0 += L.pc) {
      const int np = min(L.pc, P - p0), nr = ncc * TT + np;
      const int wbase = c0 * TT + P - p0 - np;
      __syncthreads();  // the previous pass's readers are done
      // H: row r = k*Cout + oo of hs, partition p0 + np-1 - k.
      for (int r = warp; r < np * Cout; r += nw) {
        const int k = r / Cout, oo = r - k * Cout;
        const float* src =
            hb + (((long)(p0 + np - 1 - k) * Cin + i) * Cout + oo) * 2 * K;
        float* dst = reinterpret_cast<float*>(hs + r * tb);
        for (int c = lane; c < tb; c += kLane) {
          const int kb = min(bin0 + c, K - 1);
          cp_async4(dst + 2 * c, src + kb);
          cp_async4(dst + 2 * c + 1, src + K + kb);
        }
      }
      // Window: row r = ss*nr + rr of ws, window row wbase + rr of stream
      // s0 + ss (zero past the last row).
      for (int r = warp; r < ns * nr; r += nw) {
        const int ss = r / nr, w = wbase + r - ss * nr;
        float* dst = reinterpret_cast<float*>(ws + r * tb);
        if (w >= W) {
          for (int c = lane; c < tb; c += kLane)
            reinterpret_cast<float2*>(dst)[c] = make_float2(0.f, 0.f);
          continue;
        }
        const float *re, *im;
        rows.row(s0 + ss, w, i, re, im);
        for (int c = lane; c < tb; c += kLane) {
          const int kb = min(bin0 + c, K - 1);
          cp_async4(dst + 2 * c, re + kb);
          cp_async4(dst + 2 * c + 1, im + kb);
        }
      }
      cp_async_wait();
      __syncthreads();
      if (!unit) continue;
      // Step k adds H(step k) times local row uc*TT + j + k to acc[j];
      // slot (j + k) % TT holds that row, and after the step the row
      // k + TT replaces the row k, which no later step reads.
      const float2* hrow = hs + o * tb + sub;
      const float2* wrow = ws + (us * nr + uc * TT) * tb + sub;
      const int hstep = Cout * tb;
      float2 slot[TT];
#pragma unroll
      for (int q = 0; q < TT; ++q) slot[q] = wrow[q * tb];
      for (int kb = 0; kb < np; kb += TT) {
#pragma unroll
        for (int k8 = 0; k8 < TT; ++k8) {
          const int k = kb + k8;
          if (k >= np) break;
          const float2 hv = hrow[k * hstep];
#pragma unroll
          for (int j = 0; j < TT; ++j) {
            const float2 v = slot[(j + k8) % TT];
            acc[j].x = fmaf(hv.x, v.x, fmaf(-hv.y, v.y, acc[j].x));
            acc[j].y = fmaf(hv.x, v.y, fmaf(hv.y, v.x, acc[j].y));
          }
          slot[k8] = wrow[(k + TT) * tb];
        }
      }
    }
  }
  const int k = bin0 + sub;
  if (!unit || k >= K) return;
  const int s = s0 + us;
#pragma unroll
  for (int j = 0; j < TT; ++j) {
    const int t = (c0 + uc) * TT + j;
    if (t < T) {
      const long off = (((long)s * T + t) * Cout + o) * K + k;
      yr[off] = acc[j].x;
      yi[off] = acc[j].y;
    }
  }
}

template <class Rows>
int launch(const float* h, long h_stride, Rows rows, float* yr, float* yi,
           int S, int P, int Cin, int Cout, int T, int K, void* stream) {
  const MacLayout L =
      mac_layout(S, P, Cout, T, K, h_stride == 0, sm_count());
  const size_t smem = mac_smem(L, Cout);
  auto kern = mac_kernel<Rows>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(S, L.sg) * cdiv(cdiv(T, kTBlocks), L.cg),
                  cdiv(K, L.bg * kLane));
  kern<<<grid, L.sg * Cout * L.cg * L.bg * kLane, smem,
         (cudaStream_t)stream>>>(h, h_stride, rows, yr, yi, S, P, Cin, Cout,
                                 T, K, L);
  return (int)cudaGetLastError();
}

}  // namespace

// h [S or 1, P, Cin, Cout, 2, K] (h_stride = elements per stream, 0 when
// shared); xall [S, T+P-1, Cin, K]; y [S, T, Cout, K].
extern "C" int folve_fdl_mac(const float* h, long h_stride, const float* xr,
                             const float* xi, float* yr, float* yi, int S,
                             int P, int Cin, int Cout, int T, int K,
                             void* stream) {
  return launch(h, h_stride, WindowRows{xr, xi, T + P - 1, Cin, K}, yr, yi,
                S, P, Cin, Cout, T, K, stream);
}

// h [S or 1, P, Cin, Cout, 2, K] (h_stride = elements per stream, 0 when
// shared); hist [S, P-1, Cin, K]; x [S, T, Cin, K]; y [S, T, Cout, K].
extern "C" int folve_fdl_mac_split(const float* h, long h_stride,
                                   const float* hist_re, const float* hist_im,
                                   const float* xr, const float* xi,
                                   float* yr, float* yi, int S, int P,
                                   int Cin, int Cout, int T, int K,
                                   void* stream) {
  return launch(h, h_stride,
                SplitRows{hist_re, hist_im, xr, xi, P, T, Cin, K}, yr, yi, S,
                P, Cin, Cout, T, K, stream);
}
