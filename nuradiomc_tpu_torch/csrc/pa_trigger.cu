// Fused phased-array trigger chain for Hopper (sm_90a): full irfft -> max
// amplitude; decimating irfft -> floor ADC with saturation -> FFT upsample
// -> static-roll coherent beams -> sliding power sums -> threshold on the
// frame grid -> fired and first frame.
//
// Replaces nuradiomc_tpu/ops/pa_pallas.py::fused_pa_trigger (kernel _kernel,
// _sliding_sum_fwd; pallas_call at pa_pallas.py:181). Per event group g (rows
// (g, c), channel fastest), X[c] the row's K spectrum bins:
//
//   amp[c]    = max_n |scale_full * irfft(X[c], n_base)[n]|
//   dec[c, m] = scale_dec * irfft(X[c], n_hi)[m * decim],  m < n_dec = ceil(n_hi / decim)
//   q[c, m]   = (clip(floor((dec - v_min) / lsb), 0, n_counts - 1) + off) * lsb
//   up[c, :]  = up * irfft(rfft(q[c]), n = n_up),  n_up = n_dec * up
//   beam_b[m] = sum_c up[c, (m - roll[b, c]) mod n_up]       (torch.roll)
//   P_b[f]    = sum_{i < window} beam_b[f * step + i]^2 / window,
//               f < (n_up - window) / step
//   fired     = any_{b, f} P_b[f] > threshold,  frame = fired ? min f : 0
//
// The transforms are numpy's irfft and rfft: the TPU kernel's dense matrices
// (pipeline._irfft_matrices, _decimating_irfft_matrices,
// _fft_upsample_matrix) are exactly these maps. The ADC divides by lsb, as
// ops/adc.py does; the products before it are rounded (__fmul_rn) so no FMA
// contraction moves a count boundary. Beams add channels in the plain
// version's order; the window sum is direct here, a cumsum difference there.
//
// What bounds it on the H100: at the phased-array path's shape (65536 rows,
// K 512, n_base 2048, n_hi 5120, decim 10, n_up 1024, 11 beams) it reads 268
// MB of spectra in float32 (537 MB in float64), 0.08 ms (0.16 ms) at 3.35
// TB/s, and needs ~9e9 FLOP for its four real FFTs per row, the beams and the
// windows, 0.14 ms at 67 TFLOP/s. (The TPU kernel's dense products, 4.1e11
// FLOP, fed the MXU; on the CUDA cores they made the kernel compute-bound at
// 26-80 ms.)
//
// The design: a cluster of k blocks (128 threads each, persistent, groups
// G/n_clusters apart) owns whole groups, because the beams sum channels;
// k = 1 unless a group's C upsampled traces do not fit one block's shared
// memory, then the smallest k <= 8 (the portable cluster size) whose
// ceil(C / k) channels fit. Block r of the cluster takes channels
// [r Cl, (r + 1) Cl), Cl = ceil(C / k). Per channel row, in shared memory
// (fft_common.cuh): the row's K bins are staged with cp.async,
// double-buffered so the next row's copy runs during this row's transforms;
// an inverse real FFT of n_base gives the full-rate trace, read once for its
// maximum and never kept; the decimated trace is an inverse real FFT of n_dec
// of the folded spectrum (FoldIn) when decim divides n_hi, else the full
// inverse of n_hi read at the stride; the ADC is applied as the forward real
// FFT of n_dec reads the trace (up > 1), and the inverse real FFT of n_up over
// its bins lands in the channel's slot of the block's upsampled traces, the
// only trace kept (Cl n_up values). After a cluster barrier each block forms
// the powers of beams r, r + k, ... once per sample, summing all C channels
// in order from the cluster's blocks (distributed shared memory,
// map_shared_rank), two beams' alternating in the FFT buffers, and sums them
// over each frame's window directly; the first frame is a block minimum, then
// an atomic minimum in rank 0's shared memory, which rank 0 writes out after
// a second cluster barrier (that barrier also keeps every block's traces in
// place until all readers are done). Every block gets the same scalars, so
// they agree on the ADC and the threshold arithmetic.

#include <cooperative_groups.h>

#include "fft_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int NTH = 128;     // threads per block
constexpr int NWARP = NTH / 32;
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr size_t SMEM_LIMIT = 232448;   // shared memory one block may use (H100)
// blocks per SM the registers must allow: 5 in float32 (shared memory at the
// phased-array shape allows 5), 2 in float64
template <typename T> constexpr int min_blocks() { return sizeof(T) == 4 ? 5 : 2; }

using fftc::Vec2;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

struct PaParams {
  int G, C, K;
  int k, Cl;           // blocks a group's cluster has, channels a block holds
  int Kh;              // bins the n_hi transform uses: min(K, n_hi / 2 + 1)
  int n_hi, decim, n_dec, up, n_up;
  int fold;            // decim divides n_hi: the folded spectrum at length n_dec
  int Lw;              // complex length of the FFT buffers
  int B, window, step, n_counts;
};

template <typename T>
struct PaScalars {
  T norm_full, norm_hi, norm_up, scale_dec, threshold, v_min, lsb, offset;
};

struct PaPlans {
  fftc::Plan base, hi, dec, upp;   // hi is used only without the fold
};

inline PaParams params_of(int G, int C, int K, int n_base, int n_hi, int decim, int up, int B,
                          int window, int step, int n_counts, int k) {
  PaParams p;
  p.G = G;
  p.C = C;
  p.K = K;
  p.k = k;
  p.Cl = k > 0 ? (C + k - 1) / k : 0;
  p.Kh = K < n_hi / 2 + 1 ? K : n_hi / 2 + 1;
  p.n_hi = n_hi;
  p.decim = decim;
  p.n_dec = decim > 0 ? (n_hi + decim - 1) / decim : 0;
  p.up = up;
  p.n_up = p.n_dec * up;
  p.fold = decim > 0 && n_hi % decim == 0;
  const int lengths[4] = {n_base, p.n_dec, p.n_up, p.fold ? 1 : n_hi};
  p.Lw = 1;
  for (int i = 0; i < 4; ++i)
    if (fftc::complex_length(lengths[i]) > p.Lw) p.Lw = fftc::complex_length(lengths[i]);
  p.B = B;
  p.window = window;
  p.step = step;
  p.n_counts = n_counts;
  return p;
}

// shared-memory layout of one block, each part 16-byte aligned:
//   staged rows [2][2 K] T | A, B [Lw] T2 | up [Cl][n_up] T |
//   amp partials [Cl][NWARP] T | rolls [B][C] int | scratch [NWARP + 1] int
// (the last int: the cluster's first frame, used in rank 0)
struct Layout {
  size_t stage, A, B, up, amp, rolls, iscr, total;
};

template <typename T>
__host__ __device__ inline Layout layout_of(const PaParams& p) {
  using T2 = typename Vec2<T>::type;
  Layout l;
  l.stage = 0;
  l.A = 2 * fftc::align16(2 * (size_t)p.K * sizeof(T));
  l.B = l.A + fftc::align16((size_t)p.Lw * sizeof(T2));
  l.up = l.B + fftc::align16((size_t)p.Lw * sizeof(T2));
  l.amp = l.up + fftc::align16((size_t)p.Cl * p.n_up * sizeof(T));
  l.rolls = l.amp + fftc::align16((size_t)p.Cl * NWARP * sizeof(T));
  l.iscr = l.rolls + fftc::align16((size_t)p.B * p.C * sizeof(int));
  l.total = l.iscr + (NWARP + 1) * sizeof(int);
  return l;
}

// the ADC of decimated sample m (the trace's sample m * stride)
template <typename T>
struct Adc {
  fftc::Trace<T> x;
  int stride;
  T scale_dec, v_min, lsb, top, offset;
  int32_t* counts;     // the row's counts before the offset (a diagnostic), or null
  __device__ T operator()(int m) const {
    const T tr = mul_rn(x(m * stride), scale_dec);
    T c = floor((tr - v_min) / lsb);
    c = min(max(c, T(0)), top);
    if (counts) counts[m] = (int32_t)c;
    return mul_rn(c + offset, lsb);
  }
};

template <typename T>
__global__ void __launch_bounds__(NTH, min_blocks<T>()) pa_trigger_kernel(
    const T* __restrict__ spec_re, const T* __restrict__ spec_im,
    const int* __restrict__ rolls, const typename Vec2<T>::type* __restrict__ Eb,
    const typename Vec2<T>::type* __restrict__ Eh, const typename Vec2<T>::type* __restrict__ Ed,
    const typename Vec2<T>::type* __restrict__ Eu, uint8_t* __restrict__ fired_out,
    int32_t* __restrict__ frame_out, T* __restrict__ amp_out, int32_t* __restrict__ counts_out,
    const __grid_constant__ PaParams p, const __grid_constant__ PaScalars<T> sc,
    const __grid_constant__ PaPlans pl) {
  using T2 = typename Vec2<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int k = p.k;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int C = p.C, K = p.K, Cl = p.Cl;
  const int c_lo = rank * Cl;
  const int c_hi = min(C, c_lo + Cl);            // the block's channels [c_lo, c_hi)
  const Layout lay = layout_of<T>(p);
  T* stage = reinterpret_cast<T*>(smem_raw + lay.stage);
  const size_t sst = lay.A / 2 / sizeof(T);      // elements per staging buffer
  T2* A = reinterpret_cast<T2*>(smem_raw + lay.A);
  T2* B = reinterpret_cast<T2*>(smem_raw + lay.B);
  T* up = reinterpret_cast<T*>(smem_raw + lay.up);
  T* amp_s = reinterpret_cast<T*>(smem_raw + lay.amp);
  int* rolls_s = reinterpret_cast<int*>(smem_raw + lay.rolls);
  int* iscr = reinterpret_cast<int*>(smem_raw + lay.iscr);
  int* cl_first = iscr + NWARP;                  // the cluster's first frame (rank 0's)
  // the upsampled traces of every block of the cluster, own ones directly
  const T* up_of[MAX_CLUSTER];
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r)
    up_of[r] = r == rank ? up : (r < k ? cluster.map_shared_rank(up, r) : nullptr);
  int* cl_first0 = rank == 0 ? cl_first : cluster.map_shared_rank(cl_first, 0);

  const int nf = (p.n_up - p.window) / p.step;   // frames on the grid
  const bool packed_dec = p.fold ? p.n_dec % 2 == 0 : p.n_hi % 2 == 0;
  const T top = T(p.n_counts - 1);
  const int n_clusters = gridDim.x / k;

  int g = blockIdx.x / k;
  if (g >= p.G) return;                          // the cluster's blocks leave together
  for (int i = tid; i < p.B * C; i += NTH) rolls_s[i] = rolls[i];
  // the block's rows in order are (g, c), c in [c_lo, c_hi), for g = its
  // cluster's index, + n_clusters, ...; row number ``it`` of the block is
  // staged in buffer it & 1
  auto fetch = [&](size_t row, int buf) {
    T* s = stage + buf * sst;
    fftc::row_async(s, spec_re + row * K, K);
    fftc::row_async(s + K, spec_im + row * K, K);
    fftc::cp_async_commit();
  };
  fetch((size_t)g * C + c_lo, 0);
  int it = 0;
  for (; g < p.G; g += n_clusters) {
    const size_t row0 = (size_t)g * C;
    for (int c = c_lo; c < c_hi; ++c, ++it) {
      const int lc = c - c_lo;                   // the channel's slot in the block
      const T* s = stage + (it & 1) * sst;
      fftc::cp_async_wait_all();
      __syncthreads();                           // the row is staged; the other buffer free
      const int ng = c + 1 < c_hi ? g : g + n_clusters;
      if (ng < p.G) fetch(c + 1 < c_hi ? row0 + c + 1 : (size_t)ng * C + c_lo, (it + 1) & 1);
      const fftc::StagedRow<T> X{s, K};

      // ---- full-rate trace: its maximum, not kept ------------------------------
      fftc::fill(A, pl.base.L, fftc::IrfftIn<T, fftc::StagedRow<T>>{X, K, pl.base.n, pl.base.L,
                                                                    Eb, sc.norm_full});
      T2* rb = fftc::run<T, +1>(A, B, pl.base, Eb);
      T2* o = rb == A ? B : A;
      {
        const fftc::Trace<T> x{rb, pl.base.n % 2 == 0};
        T m = T(0);
        for (int t = tid; t < pl.base.n; t += NTH) m = max(m, abs(x(t)));
        m = fftc::warp_max(m);
        if (lane == 0) amp_s[lc * NWARP + wid] = m;
      }

      // ---- decimated trace (o is free while rb is read above) -----------------
      T2* rd;
      if (p.fold) {
        using Fold = fftc::FoldIn<T, fftc::StagedRow<T>>;
        fftc::fill(o, pl.dec.L, fftc::IrfftIn<T, Fold>{Fold{X, p.Kh, p.n_hi, p.n_dec},
                                                       p.n_dec / 2 + 1, p.n_dec, pl.dec.L, Ed,
                                                       sc.norm_hi});
        rd = fftc::run<T, +1>(o, rb, pl.dec, Ed);
      } else {
        fftc::fill(o, pl.hi.L, fftc::IrfftIn<T, fftc::StagedRow<T>>{X, p.Kh, p.n_hi, pl.hi.L,
                                                                    Eh, sc.norm_hi});
        rd = fftc::run<T, +1>(o, rb, pl.hi, Eh);
      }

      // ---- ADC, then the upsampled trace into the channel's slot ----------------
      T* slot = up + (size_t)lc * p.n_up;
      const Adc<T> adc{fftc::Trace<T>{rd, packed_dec}, p.fold ? 1 : p.decim, sc.scale_dec,
                       sc.v_min, sc.lsb, top, sc.offset,
                       counts_out ? counts_out + (row0 + c) * p.n_dec : nullptr};
      if (p.up == 1) {                           // irfft(rfft(q), n_dec) is q
        for (int m = tid; m < p.n_dec; m += NTH) slot[m] = adc(m);
        continue;
      }
      T2* q = rd == A ? B : A;
      fftc::fill(q, pl.dec.L, fftc::RfftIn<T, Adc<T>>{adc, p.n_dec, p.n_dec});
      T2* rq = fftc::run<T, -1>(q, rd, pl.dec, Ed);
      T2* wbuf = rq == A ? B : A;
      const fftc::IrfftIn<T, fftc::RfftOut<T>> in{fftc::RfftOut<T>{rq, &pl.dec, Ed},
                                                  p.n_dec / 2 + 1, p.n_up, pl.upp.L, Eu,
                                                  sc.norm_up};
      if (p.n_up % 2 == 0) {                     // the last stage lands in the slot
        T2* sl = reinterpret_cast<T2*>(slot);
        T2* first = pl.upp.nst % 2 == 0 ? sl : wbuf;
        fftc::fill(first, pl.upp.L, in);
        fftc::run<T, +1>(first, first == sl ? wbuf : sl, pl.upp, Eu);
      } else {                                   // the trace is Re of the result
        fftc::fill(wbuf, pl.upp.L, in);
        const T2* ru = fftc::run<T, +1>(wbuf, rq, pl.upp, Eu);
        for (int t = tid; t < p.n_up; t += NTH) slot[t] = ru[t].x;
      }
    }
    __syncthreads();                             // the block's traces and amp partials

    for (int cc = c_lo + tid; cc < c_hi; cc += NTH) {
      const int lc = cc - c_lo;
      T m = amp_s[lc * NWARP];
#pragma unroll
      for (int w = 1; w < NWARP; ++w) m = max(m, amp_s[lc * NWARP + w]);
      amp_out[row0 + cc] = m;
    }
    if (rank == 0 && tid == 0) *cl_first = nf;
    cluster.sync();                              // every block's traces; rank 0's minimum reset

    // ---- beams r, r + k, ...: window power sums, threshold, first frame --------
    // a beam's powers in pw[j & 1] (j its number in the block): the FFT
    // buffers, free until the next group
    T* pw[2] = {reinterpret_cast<T*>(A), reinterpret_cast<T*>(B)};
    auto beam_power = [&](int b, T* out) {
      const int* rb_c = rolls_s + b * C;
      for (int m = tid; m < p.n_up; m += NTH) {
        T v = T(0);
        for (int r = 0; r < k; ++r) {            // the channels in order, block by block
          const T* u = up_of[r];
          const int c1 = min(C, (r + 1) * Cl);
          for (int cc = r * Cl; cc < c1; ++cc, u += p.n_up) {
            int idx = m - rb_c[cc];
            if (idx < 0) idx += p.n_up;
            v += u[idx];
          }
        }
        out[m] = mul_rn(v, v);
      }
    };
    int first = nf;                              // the thread's first frame above
    const int nb = rank < p.B ? (p.B - rank + k - 1) / k : 0;   // the block's beams
    if (nb > 0) beam_power(rank, pw[0]);
    __syncthreads();
    for (int j = 0; j < nb; ++j) {
      if (j + 1 < nb) beam_power(rank + (j + 1) * k, pw[(j + 1) & 1]);
      const T* P = pw[j & 1];
      for (int f = tid; f < nf && f < first; f += NTH) {
        T sum = T(0);
        const T* w0 = P + f * p.step;
        for (int i = 0; i < p.window; ++i) sum += w0[i];
        if (sum / T(p.window) > sc.threshold) {
          first = f;
          break;
        }
      }
      __syncthreads();                           // beam j read; its buffer free
    }
    first = fftc::block_min<NWARP>(first, iscr);
    if (tid == 0 && first < nf) atomicMin(cl_first0, first);
    cluster.sync();                              // every minimum in; every trace read
    if (rank == 0 && tid == 0) {
      const int f0 = *cl_first;
      fired_out[g] = f0 < nf ? 1 : 0;
      frame_out[g] = f0 < nf ? f0 : 0;
    }
  }
  fftc::cp_async_wait_all();
}

// the cluster a group gets: the smallest k <= MAX_CLUSTER whose ceil(C / k)
// channels fit one block's shared memory, taken down to ceil(C / Cl) so that
// every block holds at least one channel; 0 when none fits
template <typename T>
int cluster_of(PaParams p) {
  for (int k = 1; k <= MAX_CLUSTER && k <= p.C; ++k) {
    p.k = k;
    p.Cl = (p.C + k - 1) / k;
    if (layout_of<T>(p).total <= SMEM_LIMIT) return (p.C + p.Cl - 1) / p.Cl;
  }
  return 0;
}

template <typename T>
PaParams with_cluster(PaParams p) {
  p.k = cluster_of<T>(p);
  p.Cl = p.k > 0 ? (p.C + p.k - 1) / p.k : 0;
  return p;
}

// a launch of k-block clusters: the grid is filled with as many clusters as
// fit on the card at once (after the kernel's dynamic shared memory is
// allowed), at most one per group
template <typename T>
cudaError_t grid_of(const PaParams& p, size_t smem, int* n_blocks) {
  auto kernel = pa_trigger_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(p.k);
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n_clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&n_clusters, (const void*)kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (n_clusters < 1) return cudaErrorInvalidConfiguration;
  *n_blocks = (p.G < n_clusters ? p.G : n_clusters) * p.k;
  return cudaSuccess;
}

bool params_ok(const PaParams& p, int n_base) {
  return p.G >= 1 && p.C >= 1 && p.K >= 1 && p.K <= n_base / 2 + 1 && n_base >= 2 &&
         p.n_hi >= 2 && p.decim >= 1 && p.n_dec >= 2 && p.up >= 1 && p.B >= 1 &&
         p.window >= 1 && p.step >= 1 && p.n_up >= p.window && p.n_counts >= 1 &&
         p.k >= 1 && p.k <= MAX_CLUSTER && (p.k - 1) * p.Cl < p.C && p.k * p.Cl >= p.C;
}

template <typename T>
int launch(const T* spec_re, const T* spec_im, const int* rolls, const void* Eb, const void* Eh,
           const void* Ed, const void* Eu, uint8_t* fired, int32_t* frame, T* amp,
           int32_t* counts, const PaParams& p, int n_base, const PaPlans& pl,
           const PaScalars<T>& sc, void* stream) {
  using T2 = typename Vec2<T>::type;
  if (!params_ok(p, n_base) || pl.base.n != n_base || pl.dec.n != p.n_dec ||
      pl.upp.n != p.n_up || (!p.fold && pl.hi.n != p.n_hi) || !fftc::plan_ok(pl.base) ||
      !fftc::plan_ok(pl.dec) || !fftc::plan_ok(pl.upp) || (!p.fold && !fftc::plan_ok(pl.hi)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = layout_of<T>(p).total;
  int n_blocks = 0;
  cudaError_t err = grid_of<T>(p, smem, &n_blocks);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(n_blocks);
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pa_trigger_kernel<T>, spec_re, spec_im, rolls,
                           static_cast<const T2*>(Eb), static_cast<const T2*>(Eh),
                           static_cast<const T2*>(Ed), static_cast<const T2*>(Eu), fired, frame,
                           amp, counts, p, sc, pl);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_c(const T* spec_re, const T* spec_im, const int* rolls, const void* Eb,
             const void* Eh, const void* Ed, const void* Eu, uint8_t* fired, int32_t* frame,
             T* amp, int32_t* counts, int G, int C, int K, int n_base, int n_hi, int decim,
             int up, int B, int window, int step, int n_counts, const int* radix_base,
             int nst_base, const int* radix_hi, int nst_hi, const int* radix_dec, int nst_dec,
             const int* radix_up, int nst_up, T norm_full, T norm_hi, T norm_up, T scale_dec,
             T threshold, T v_min, T lsb, T offset, void* stream) {
  const PaParams p = with_cluster<T>(
      params_of(G, C, K, n_base, n_hi, decim, up, B, window, step, n_counts, 1));
  if (!params_ok(p, n_base)) return (int)cudaErrorInvalidValue;
  const PaPlans pl = {fftc::make_plan(n_base, radix_base, nst_base),
                      fftc::make_plan(n_hi, radix_hi, nst_hi),
                      fftc::make_plan(p.n_dec, radix_dec, nst_dec),
                      fftc::make_plan(p.n_up, radix_up, nst_up)};
  const PaScalars<T> sc = {norm_full, norm_hi, norm_up, scale_dec, threshold, v_min, lsb, offset};
  return launch<T>(spec_re, spec_im, rolls, Eb, Eh, Ed, Eu, fired, frame, amp, counts, p, n_base,
                   pl, sc, stream);
}

PaParams sized(int G, int C, int K, int n_base, int n_hi, int decim, int up, int B, int f64) {
  const PaParams p = params_of(G, C, K, n_base, n_hi, decim, up, B, 1, 1, 1, 1);
  return f64 ? with_cluster<double>(p) : with_cluster<float>(p);
}

}  // namespace

extern "C" {

// the blocks of a group's cluster at these sizes (1 to 8), or 0 when even
// eight blocks cannot hold the group's upsampled traces
int pa_trigger_cluster(int C, int K, int n_base, int n_hi, int decim, int up, int B, int f64) {
  return sized(1, C, K, n_base, n_hi, decim, up, B, f64).k;
}

// shared memory one block of that cluster needs (at eight blocks when none fits)
long pa_trigger_smem_bytes(int C, int K, int n_base, int n_hi, int decim, int up, int B,
                           int f64) {
  PaParams p = sized(1, C, K, n_base, n_hi, decim, up, B, f64);
  if (p.k == 0) {
    p.k = MAX_CLUSTER;
    p.Cl = (C + MAX_CLUSTER - 1) / MAX_CLUSTER;
  }
  return (long)(f64 ? layout_of<double>(p).total : layout_of<float>(p).total);
}

// the grid a launch of these sizes uses (blocks, k per group), or -1
int pa_trigger_grid(int G, int C, int K, int n_base, int n_hi, int decim, int up, int B,
                    int f64) {
  const PaParams p = sized(G, C, K, n_base, n_hi, decim, up, B, f64);
  if (p.k == 0) return -1;
  int n = 0;
  const cudaError_t err = f64 ? grid_of<double>(p, layout_of<double>(p).total, &n)
                              : grid_of<float>(p, layout_of<float>(p).total, &n);
  return err == cudaSuccess ? n : -1;
}

// counts: null, or [G * C, n_dec] int32 for the ADC counts before the offset
int pa_trigger_f32(const float* spec_re, const float* spec_im, const int* rolls, const void* Eb,
                   const void* Eh, const void* Ed, const void* Eu, uint8_t* fired,
                   int32_t* frame, float* amp, int32_t* counts, int G, int C, int K,
                   int n_base, int n_hi, int decim, int up, int B, int window, int step,
                   int n_counts, const int* radix_base, int nst_base, const int* radix_hi,
                   int nst_hi, const int* radix_dec, int nst_dec, const int* radix_up,
                   int nst_up, float norm_full, float norm_hi, float norm_up, float scale_dec,
                   float threshold, float v_min, float lsb, float offset, void* stream) {
  return launch_c<float>(spec_re, spec_im, rolls, Eb, Eh, Ed, Eu, fired, frame, amp, counts, G,
                         C, K, n_base, n_hi, decim, up, B, window, step, n_counts, radix_base,
                         nst_base, radix_hi, nst_hi, radix_dec, nst_dec, radix_up, nst_up,
                         norm_full, norm_hi, norm_up, scale_dec, threshold, v_min, lsb, offset,
                         stream);
}

int pa_trigger_f64(const double* spec_re, const double* spec_im, const int* rolls,
                   const void* Eb, const void* Eh, const void* Ed, const void* Eu,
                   uint8_t* fired, int32_t* frame, double* amp, int32_t* counts, int G, int C,
                   int K, int n_base, int n_hi, int decim, int up, int B, int window, int step,
                   int n_counts, const int* radix_base, int nst_base, const int* radix_hi,
                   int nst_hi, const int* radix_dec, int nst_dec, const int* radix_up,
                   int nst_up, double norm_full, double norm_hi, double norm_up,
                   double scale_dec, double threshold, double v_min, double lsb,
                   double offset, void* stream) {
  return launch_c<double>(spec_re, spec_im, rolls, Eb, Eh, Ed, Eu, fired, frame, amp, counts,
                          G, C, K, n_base, n_hi, decim, up, B, window, step, n_counts,
                          radix_base, nst_base, radix_hi, nst_hi, radix_dec, nst_dec, radix_up,
                          nst_up, norm_full, norm_hi, norm_up, scale_dec, threshold, v_min, lsb,
                          offset, stream);
}

}  // extern "C"
