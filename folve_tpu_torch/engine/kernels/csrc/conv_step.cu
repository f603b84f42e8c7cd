// Fused convolution step: forward FFT -> FDL MAC -> inverse + overlap-add
// + clipping max in one call (kernel of engine/kernels/conv_step.py;
// replaces folve_tpu conv_step.py _kernel behind pallas_conv_step_fused
// and pallas_conv_step_fused_pre).
//
// Bound on the H100: bytes.  At the flagship shape (n = 16384, P = 16,
// Cin = Cout = 2, S = T = 8) the function moves about 46 MB (the filter
// spectra H once, the audio in and out, the hist carry in and out, the
// tail) against 0.42 GFLOP: 0.0136 ms at 3.35 TB/s, as chip_smoke.py
// computes it.
//
// The TPU kernel walks t in order (grid (s, t), t "arbitrary") because
// that is how it keeps H and the ring of past spectra resident in VMEM.
// The function has no such chain: every block's forward FFT is
// independent, the MAC over the window [hist; this chunk's spectra] is
// elementwise in bins, and the overlap-add is a two-term sum per sample.
// So the step runs as four phases, each over the whole card, launched in
// order on the caller's stream (the stream orders them; nothing spins):
//   A  forward_kernel, block (s, t, i): radix::forward (the body of
//      fft_half.cu) on x[s, t, i] into scratch X [S, T, Cin, 2, K]; it
//      also pre-sets the overlap-add targets (y[s, 0] = tail_in,
//      y[s, t > 0] = 0) and zeroes max_out;
//   B  mac_kernel, block (tile of 32 bins, group of streams and blocks):
//        Y[s, t, o] = wn * sum_i sum_p H[p, i, o] * W[s, t + P-1 - p, i]
//      over the live paths (i, o) only, where window row w is hist[w]
//      for w < P-1, else X[w - (P-1)].  For each input channel with a
//      live path and chunk of partitions the block stages the window
//      rows and H's tile of that input's live outputs in shared memory.
//      A warp owns (s, o, 8 blocks t) and keeps their sums in registers;
//      each step of p reads one value of H and one new window row (the 8
//      rows a step needs slide through registers), so 32 FMAs cost two
//      shared loads.  H is read once per group of streams: once per call
//      at the flagship.
//      In copy-out mode the blocks of the first group of blocks t also
//      write the new hist, hist_out[s, j] = W[s, T + j] (j < P-1), which
//      covers both T >= P-1 and the T < P-1 shift;
//   C  inverse_kernel, block (s, t, o): radix::inverse (the body of
//      ifft_half.cu) on Y[s, t, o] with the overlap-add store
//      (radix::OlaStore): deterministic two-term atomicAdds into y[s, t]
//      and y[s, t+1], or the new tail at the last t.  In ring mode it
//      first writes this chunk's spectra X[s, t, i] (i = o mod Cout) of
//      the last min(T, P-1) blocks t into the hist in place (below);
//   D  max_kernel, block (s, t, o, span of samples): the masked max|y|
//      (frames < valid[s, t]) folded into max_out[s] with an integer
//      atomicMax on the float's bits (values >= 0, so the result does not
//      depend on the order).
// Against the byte bound: device memory sees H once per call (not once
// per stream and block), x, y and the hist once each way, and X and Y
// (8.5 MB each at the flagship) stay in the 50 MB L2 between the phases.
// Separate launches give each phase its own block shape and registers:
// A and C run the FFT bodies at one 512-thread block per SM, as the split
// kernels do, and B runs blocks of its own shape at 64 registers, two per
// SM.  A CUDA graph captures the four launches.
//
// Live paths.  A conf defines some of the Cin x Cout pairs (the 5.1 bass
// management conf 11 of 36; upstream's demo lowpass 2 of 4), and the
// rest of H is exactly zero.  The launcher gets a mask of live outputs
// per input (Paths).  Phase B skips an input with no live output (no
// window rows staged), stages H only for the live outputs of the input
// it is on, and a warp whose (i, o) is dead sits the pass out: no zero
// tile is read and no zero product summed.  A warp's sum still runs over
// the live inputs in order, p within each, as the dense sum does, so the
// result equals the dense sum bit for bit (the skipped terms were exact
// zeros).  Balance: the warps stay one per (stream, output), so under
// bass management the sub's warps work in all six input passes and each
// main speaker's warps in one.  The passes are lock-stepped by the
// staging, so a block still takes Cin passes of staging (the history
// and X, which dominate its bytes) and the busiest warp's FMAs; the
// saving is the FMA issue and the H reads (11/36 of them), which leave
// the SM's pipes to the staging loads and to the block beside it.  The
// sum of one output is not split across warps: that would change the
// order of the sum.  A table with every pair live (true stereo) runs an
// instance compiled without the table, the dense body: the table's
// lookups and the registers they hold cost a full table about 1.3% of
// phase B's time on the H100.
//
// Layouts.  X, Y and H use the transposed bin order kk = c*m1 + q of the
// JAX fused kernel (q the k1 row, c the k2 column), so h_perm and a
// hist_t carry are read as they are; a canonical hist (hist_t = 0, bin
// q*cols + c) is re-indexed at the import and export in phase B.  The
// radix FFTs work on [q][c] rows in shared memory: phase A copies the
// forward's rows out in kk order, phase C loads Y's rows from kk order;
// both move neighbouring threads over neighbouring q, which is coalesced
// in device memory and free of bank conflicts (odd row stride).
//
// The hist, two ways.  Copy-out (head < 0; a canonical StreamState's
// callers): hist_in and hist_out are separate buffers, row w oldest
// first, and phase B writes all P-1 rows of hist_out: a tile's export
// into hist_in would overwrite window rows that other blocks still read.
// Ring mode (head >= 0; the serving carry): the hist is a ring whose
// oldest row sits in slot head, so window row w < P-1 is slot (head + w)
// mod (P-1), and hist_out is hist_in.  Of the new hist W[T .. T+P-2],
// rows still in the old hist stay in their slots; only X[t], t >=
// T - min(T, P-1), is written, into slot (head + t) mod (P-1), the slot
// of an old row that this step reads and the next one does not.  The
// caller's head becomes (head + T) mod (P-1).  Phase C writes them: a
// slot's old row is read by every chunk group whose window reaches it,
// and the blocks of one launch run in no order, so no block of phase B
// knows when the last reader of a slot is done; the stream starts phase
// C after all of phase B.  Phase C reads X again for it (the copy-out
// export does the same, and reads the old rows besides), and writes
// min(T, P-1) rows a stream where copy-out writes P-1.
#include <algorithm>

#include "fft_radix.cuh"

using folve::Plan;
namespace radix = folve::radix;

namespace {

// MAC: bins of a tile (one per lane), blocks t a thread accumulates, the
// most warps of a block (Cout <= 16 fits one (stream, chunk) in a block),
// and the shared memory a block stages into (two blocks per SM).
constexpr int kTileBins = 32;
constexpr int kTBlocks = 8;
constexpr int kMacWarps = 16;
constexpr size_t kMacSmem = 96 * 1024;
// Channels on each side (conv_step.py's MAX_CHANNELS): Cout by the warps
// of a block, Cin and Cout by the path table.
constexpr int kMaxChannels = 16;

// The live paths, a parameter of phase B alone: bit o of mask[i] is set
// when input i feeds output o; outs[i] lists those outputs in order,
// four bits each.
struct Paths {
  unsigned mask[kMaxChannels];
  unsigned long long outs[kMaxChannels];
};
// Max: threads of a block, and the samples of one channel it reads.
constexpr int kMaxThreads = 256;
constexpr int kMaxSpan = 2048;

struct Args {
  const float* h;        // [P, Cin, Cout, 2, K], bin kk
  const float* x;        // [S, T, Cin, B]
  const float* hist_re;  // [S, P-1, Cin, K], bin q*cols + c (kk if hist_t)
  const float* hist_im;
  const float* tail_in;  // [S, Cout, B]
  float* y;              // [S, T, Cout, B]
  float* hist_re_out;    // like hist_re; hist_re itself in ring mode
  float* hist_im_out;
  float* tail_out;       // [S, Cout, B]
  float* max_out;        // [S]
  float* X;              // scratch [S, T, Cin, 2, K], bin kk
  float* Y;              // scratch [S, T, Cout, 2, K], bin kk, times wn
  int S, P, Cin, Cout, T, hist_t;
  int head;              // ring slot of the oldest row, or -1: copy-out
};

// Phase B's blocks: sg streams and cg chunks of kTBlocks blocks t (one
// warp per (stream, o, chunk)), and pc partitions (a multiple of
// kTBlocks) staged per pass.
struct MacLayout {
  int sg, cg, pc;
};

constexpr size_t mac_smem(int Cout, int sg, int cg, int pc) {
  return (size_t)(pc * Cout + sg * (cg * kTBlocks + pc)) * kTileBins *
         sizeof(float2);
}

MacLayout mac_layout(int S, int P, int Cout, int T) {
  const int nch = (T + kTBlocks - 1) / kTBlocks;
  MacLayout L;
  L.cg = std::min(nch, std::max(1, kMacWarps / Cout));
  L.sg = std::min(S, std::max(1, kMacWarps / (Cout * L.cg)));
  L.pc = kTBlocks;
  while (L.pc < P && mac_smem(Cout, L.sg, L.cg, L.pc + kTBlocks) <= kMacSmem)
    L.pc += kTBlocks;
  return L;
}

// store(idx, load(idx)) for idx = tid, tid + nt, ... < n, with kBatch
// loads in flight per thread before their stores: a loop of one load and
// one store per element would wait out the memory latency each time.
constexpr int kBatch = 8;
template <class Load, class Store>
__device__ __forceinline__ void copy_batched(int n, int nt, Load load,
                                             Store store) {
  for (int base = threadIdx.x; base < n; base += kBatch * nt) {
    float2 v[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e)
      if (base + e * nt < n) v[e] = load(base + e * nt);
#pragma unroll
    for (int e = 0; e < kBatch; ++e)
      if (base + e * nt < n) store(base + e * nt, v[e]);
  }
}

// Bin kk in the hist's layout: kk itself for the transposed carry, else
// the canonical q*cols + c.
template <int M1, int COLS>
__device__ __forceinline__ int hist_bin(const Args& a, int kk) {
  return a.hist_t ? kk : (kk % M1) * COLS + kk / M1;
}

// Window row w of stream s, input channel i, at bin kk (hist layout bin
// hb): hist row w (slot (head + w) mod (P-1) in ring mode) for w < P-1,
// else this chunk's spectrum X[w - (P-1)].
__device__ __forceinline__ float2 window(const Args& a, int K, int s, int w,
                                         int i, int kk, int hb) {
  const int pm1 = a.P - 1;
  if (w < pm1) {
    const int r = w + max(a.head, 0), slot = r < pm1 ? r : r - pm1;
    const long off = (((long)s * pm1 + slot) * a.Cin + i) * K + hb;
    return make_float2(__ldg(a.hist_re + off), __ldg(a.hist_im + off));
  }
  const long off = (((long)s * a.T + w - pm1) * a.Cin + i) * 2 * K + kk;
  return make_float2(__ldg(a.X + off), __ldg(a.X + off + K));
}

// Phase A, block (s, t, i) = (s*T + t)*Cin + i.
template <int M1, int M2>
__global__ void __launch_bounds__(radix::Shape<M1, M2>::THREADS, 1)
    forward_kernel(Args a, Plan P) {
  using Sh = radix::Shape<M1, M2>;
  constexpr int LD = Sh::LD, NT = Sh::THREADS, K = M1 * Sh::COLS;
  constexpr int B = M1 * M2 / 2;
  extern __shared__ float smem[];
  float2* sm = reinterpret_cast<float2*>(smem);
  const int item = blockIdx.x, tid = threadIdx.x;
  radix::forward<M1, M2>(sm, a.x + (long)item * B, B, P, 0, M1, [&] {
    return [=](int q, int c, float re, float im) {
      sm[q * LD + c] = make_float2(re, im);
    };
  });
  // The overlap-add targets of channels o = i (mod Cin), and max_out.
  const int i = item % a.Cin, st = item / a.Cin;
  const int t = st % a.T, s = st / a.T;
  for (int o = i; o < a.Cout; o += a.Cin) {
    float* yo = a.y + ((long)st * a.Cout + o) * B;
    const float* tl = a.tail_in + ((long)s * a.Cout + o) * B;
    copy_batched(
        B, NT,
        [&](int f) { return make_float2(t == 0 ? __ldg(tl + f) : 0.f, 0.f); },
        [&](int f, float2 v) { yo[f] = v.x; });
  }
  if (t == 0 && i == 0 && tid == 0) a.max_out[s] = 0.f;
  __syncthreads();
  float* xr = a.X + (long)item * 2 * K;
  float* xi = xr + K;
  for (int kk = tid; kk < K; kk += NT) {
    const float2 v = sm[(kk % M1) * LD + kk / M1];
    xr[kk] = v.x;
    xi[kk] = v.y;
  }
}

// Phase B, block (tile, group): grid (tiles, stream groups x chunk
// groups).  Shared memory per pass (input channel i, partitions p0 ..
// p0 + np - 1): hs [kp][nl][kTileBins], H of i's nl live outputs at step
// k = partition p0 + np-1 - k (zero for k >= np, kp = np rounded up to
// kTBlocks), then
// ws [ns][rows][kTileBins], local row r = window row wbase + r (zero past
// the window's last row T + P-2).  kAll: every pair is live, so the
// table is not read (the dense body).
template <int M1, int M2, bool kAll>
__global__ void __launch_bounds__(kMacWarps * kTileBins, 2)
    mac_kernel(Args a, Plan P, MacLayout L, Paths paths) {
  constexpr int COLS = radix::Shape<M1, M2>::COLS, K = M1 * COLS;
  constexpr int TB = kTileBins, TT = kTBlocks;
  extern __shared__ float smem[];
  float2* hs = reinterpret_cast<float2*>(smem);
  float2* ws = hs + L.pc * a.Cout * TB;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % TB, warp = tid / TB;
  const int Cin = a.Cin, Cout = a.Cout, T = a.T, Pn = a.P;
  const int nch = (T + TT - 1) / TT, ncg = (nch + L.cg - 1) / L.cg;
  const int s0 = blockIdx.y / ncg * L.sg, c0 = blockIdx.y % ncg * L.cg;
  const int ns = min(L.sg, a.S - s0), ncc = min(L.cg, nch - c0);
  const int tile = blockIdx.x, kk = tile * TB + lane;
  // This warp's unit: stream s0 + us, output o, blocks (c0 + uc)*TT + j.
  const int uc = warp % L.cg, o = warp / L.cg % Cout, us = warp / L.cg / Cout;
  const bool unit = us < ns && uc < ncc;
  float2 acc[TT];
#pragma unroll
  for (int j = 0; j < TT; ++j) acc[j] = make_float2(0.f, 0.f);

  for (int i = 0; i < Cin; ++i) {
    // Input i's live outputs: nl of them, this warp's the jo-th if live
    // (with kAll every output, in order).
    unsigned long long outs = 0;
    int nl = Cout, jo = o;
    bool live = unit;
    if constexpr (!kAll) {
      const unsigned mask = paths.mask[i];
      if (mask == 0) continue;
      outs = paths.outs[i];
      nl = __popc(mask);
      jo = __popc(mask & ((1u << o) - 1u));
      live = unit && (mask >> o & 1u);
    }
    for (int p0 = 0; p0 < Pn; p0 += L.pc) {
      const int np = min(L.pc, Pn - p0), kp = (np + TT - 1) / TT * TT;
      const int rows = ncc * TT + kp, wbase = c0 * TT + Pn - p0 - np;
      __syncthreads();  // the previous pass's readers are done
      copy_batched(
          kp * nl * TB, nt,
          [&](int idx) {
            const int k = idx / (nl * TB);
            const int oo = kAll ? idx / TB % Cout
                                : (int)(outs >> (4 * (idx / TB % nl))) & 15;
            const int kb = min(tile * TB + idx % TB, K - 1);
            if (k >= np) return make_float2(0.f, 0.f);
            const float* hp =
                a.h + (((long)(p0 + np - 1 - k) * Cin + i) * Cout + oo) * 2 * K +
                kb;
            return make_float2(__ldg(hp), __ldg(hp + K));
          },
          [&](int idx, float2 v) { hs[idx] = v; });
      copy_batched(
          ns * rows * TB, nt,
          [&](int idx) {
            const int r = idx / TB % rows, ss = idx / TB / rows;
            const int kb = min(tile * TB + idx % TB, K - 1), w = wbase + r;
            if (w >= T + Pn - 1) return make_float2(0.f, 0.f);
            return window(a, K, s0 + ss, w, i, kb, hist_bin<M1, COLS>(a, kb));
          },
          [&](int idx, float2 v) { ws[idx] = v; });
      __syncthreads();
      if (!live) continue;
      // Step k adds H(step k) times local row uc*TT + j + k to acc[j];
      // slot (j + k) % TT holds that row, and after the step the row
      // k + TT replaces the row k, which no later step reads.
      const float2* hrow = hs + jo * TB + lane;
      const float2* wrow = ws + (us * rows + uc * TT) * TB + lane;
      float2 slot[TT];
#pragma unroll
      for (int q = 0; q < TT; ++q) slot[q] = wrow[q * TB];
      for (int kb = 0; kb < kp; kb += TT) {
#pragma unroll
        for (int k8 = 0; k8 < TT; ++k8) {
          const int k = kb + k8;
          const float2 h = hrow[k * nl * TB];
#pragma unroll
          for (int j = 0; j < TT; ++j) {
            const float2 v = slot[(j + k8) % TT];
            acc[j].x = fmaf(h.x, v.x, fmaf(-h.y, v.y, acc[j].x));
            acc[j].y = fmaf(h.x, v.y, fmaf(h.y, v.x, acc[j].y));
          }
          slot[k8] = wrow[(k + TT) * TB];
        }
      }
    }
  }
  if (unit && kk < K) {
    const float wn = __ldg(P.wn + (kk % M1) * COLS + kk / M1);
    const int s = s0 + us;
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      const int t = (c0 + uc) * TT + j;
      if (t < T) {
        float* yb = a.Y + (((long)s * T + t) * Cout + o) * 2 * K + kk;
        yb[0] = acc[j].x * wn;
        yb[K] = acc[j].y * wn;
      }
    }
  }

  // Copy-out: the new hist of the group's streams, hist_out[s, j] =
  // window row T + j, j < P-1; element idx of the tile is (ss, j, i, bin).
  if (c0 != 0 || a.head >= 0) return;
  const int pm1 = Pn - 1, tb = min(TB, K - tile * TB);
  copy_batched(
      ns * pm1 * Cin * tb, nt,
      [&](int idx) {
        const int kb = tile * TB + idx % tb, r = idx / tb;
        const int i = r % Cin, sj = r / Cin;
        return window(a, K, s0 + sj / pm1, T + sj % pm1, i, kb,
                      hist_bin<M1, COLS>(a, kb));
      },
      [&](int idx, float2 v) {
        const int kb = tile * TB + idx % tb;
        const long dst = ((long)s0 * pm1 * Cin + idx / tb) * K +
                         hist_bin<M1, COLS>(a, kb);
        a.hist_re_out[dst] = v.x;
        a.hist_im_out[dst] = v.y;
      });
}

// Phase C, block (s, t, o) = (s*T + t)*Cout + o.
template <int M1, int M2>
__global__ void __launch_bounds__(radix::Shape<M1, M2>::THREADS, 1)
    inverse_kernel(Args a, Plan P) {
  using Sh = radix::Shape<M1, M2>;
  constexpr int LD = Sh::LD, NT = Sh::THREADS, COLS = Sh::COLS, K = M1 * COLS;
  constexpr int B = M1 * M2 / 2;
  extern __shared__ float smem[];
  float2* sm = reinterpret_cast<float2*>(smem);
  const int item = blockIdx.x;
  const int o = item % a.Cout, st = item / a.Cout;
  const int t = st % a.T, s = st / a.T, pm1 = a.P - 1;
  // Ring mode: X[s, t, i] becomes the hist row of slot (head + t) mod
  // (P-1) for the last min(T, P-1) blocks t (phase B has read every old
  // row; see the note at the top).
  if (a.head >= 0 && t >= a.T - min(a.T, pm1)) {
    const long slot = (long)s * pm1 + (a.head + t) % pm1;
    for (int i = o; i < a.Cin; i += a.Cout) {
      const float* xr = a.X + ((long)st * a.Cin + i) * 2 * K;
      const long dst = (slot * a.Cin + i) * K;
      copy_batched(
          K, NT,
          [&](int kk) { return make_float2(__ldg(xr + kk), __ldg(xr + K + kk)); },
          [&](int kk, float2 v) {
            const long d = dst + hist_bin<M1, COLS>(a, kk);
            a.hist_re_out[d] = v.x;
            a.hist_im_out[d] = v.y;
          });
    }
  }
  const float* yr = a.Y + (long)item * 2 * K;
  const float* yi = yr + K;
  copy_batched(
      K, NT, [&](int kk) { return make_float2(__ldg(yr + kk), __ldg(yi + kk)); },
      [&](int kk, float2 v) { sm[(kk % M1) * LD + kk / M1] = v; });
  __syncthreads();
  radix::inverse<M1, M2>(sm, P, 0, M1, [&] {
    return radix::OlaStore{
        a.y + (long)item * B,
        t + 1 < a.T ? a.y + (long)(item + a.Cout) * B : nullptr,
        a.tail_out + ((long)s * a.Cout + o) * B, B};
  });
}

// Phase D, block ((s*T + t)*Cout + o, span): samples [span*kMaxSpan,
// (span + 1)*kMaxSpan) of y[s, t, o].
__global__ void __launch_bounds__(kMaxThreads)
    max_kernel(const float* y, const int* valid, float* max_out, int T,
               int Cout, int B) {
  __shared__ float red[kMaxThreads];
  const int item = blockIdx.x, tid = threadIdx.x;
  const int vb = max(0, min(valid[item / Cout], B));
  const int end = min(vb, (int)(blockIdx.y + 1) * kMaxSpan);
  const float* yo = y + (long)item * B;
  float mx = 0.f;
#pragma unroll
  for (int f = blockIdx.y * kMaxSpan + tid; f < end; f += kMaxThreads)
    mx = fmaxf(mx, fabsf(__ldg(yo + f)));
  red[tid] = mx;
  __syncthreads();
  for (int h = kMaxThreads / 2; h > 0; h >>= 1) {
    if (tid < h) red[tid] = fmaxf(red[tid], red[tid + h]);
    __syncthreads();
  }
  if (tid == 0)
    atomicMax(reinterpret_cast<int*>(max_out + item / Cout / T),
              __float_as_int(red[0]));
}

}  // namespace

// Shapes as conv_step.py's wrapper documents them; X [S, T, Cin, 2, K]
// and Y [S, T, Cout, 2, K] scratch; plan: packed plan factors.
// n = m1*m2 from 128 to 16384.  head < 0: copy-out into hist_*_out;
// 0 <= head < P-1: ring mode, hist_*_out are hist_* (written in place).
// masks: host int [Cin], bit o of masks[i] set for each path (i, o) the
// MAC computes; Cin, Cout <= kMaxChannels.  Four launches on `stream`;
// returns the first launch error.
extern "C" int folve_conv_step(
    const float* h, const float* x, const float* hist_re,
    const float* hist_im, const float* tail_in, const int* valid, float* y,
    float* hist_re_out, float* hist_im_out, float* tail_out, float* max_out,
    float* X, float* Y, const float* plan, int S, int P, int Cin, int Cout,
    int T, int m1, int m2, int hist_t, int head, const int* masks,
    void* stream) {
  if (Cin < 1 || Cin > kMaxChannels || Cout < 1 || Cout > kMaxChannels)
    return (int)cudaErrorInvalidValue;
  Paths paths{};
  for (int i = 0; i < Cin; ++i) {
    paths.mask[i] = (unsigned)masks[i] & ((1u << Cout) - 1u);
    for (int o = 0, j = 0; o < Cout; ++o)
      if (paths.mask[i] >> o & 1u)
        paths.outs[i] |= (unsigned long long)o << (4 * j++);
  }
  const Plan pl = folve::make_plan(plan, m1, m2);
  return radix::with_sizes(m1, m2, [&](auto sz) {
    using Z = decltype(sz);
    using Sh = radix::Shape<Z::M1, Z::M2>;
    constexpr int K = Z::M1 * Sh::COLS, B = Z::M1 * Z::M2 / 2;
    auto fwd = forward_kernel<Z::M1, Z::M2>;
    bool all = true;
    for (int i = 0; i < Cin; ++i) all &= paths.mask[i] == (1u << Cout) - 1u;
    auto mac = all ? mac_kernel<Z::M1, Z::M2, true>
                   : mac_kernel<Z::M1, Z::M2, false>;
    auto inv = inverse_kernel<Z::M1, Z::M2>;
    const MacLayout L = mac_layout(S, P, Cout, T);
    const size_t smem = mac_smem(Cout, L.sg, L.cg, L.pc);
    const int nch = (T + kTBlocks - 1) / kTBlocks;
    const dim3 mac_grid((K + kTileBins - 1) / kTileBins,
                        ((S + L.sg - 1) / L.sg) * ((nch + L.cg - 1) / L.cg));
    const int mac_threads = L.sg * Cout * L.cg * kTileBins;
    const Args a{h,           x,           hist_re,  hist_im, tail_in,
                 y,           hist_re_out, hist_im_out, tail_out, max_out,
                 X,           Y,           S,        P,       Cin,
                 Cout,        T,           hist_t,   head};
    const auto st = (cudaStream_t)stream;
    cudaError_t err = cudaFuncSetAttribute(
        fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          inv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          mac, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fwd<<<S * T * Cin, Sh::THREADS, Sh::SMEM, st>>>(a, pl);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    mac<<<mac_grid, mac_threads, smem, st>>>(a, pl, L, paths);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    inv<<<S * T * Cout, Sh::THREADS, Sh::SMEM, st>>>(a, pl);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const dim3 max_grid(S * T * Cout, (B + kMaxSpan - 1) / kMaxSpan);
    max_kernel<<<max_grid, kMaxThreads, 0, st>>>(y, valid, max_out, T, Cout, B);
    return (int)cudaGetLastError();
  });
}
