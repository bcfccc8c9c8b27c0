// Fused trigger-trace irfft + high/low (or threshold) trigger + majority
// logic for Hopper (sm_90a).
//
// Replaces nuradiomc_tpu/ops/trigger_pallas.py::fused_irfft_trigger (kernel
// _kernel, _swa; pallas_call at trigger_pallas.py:172). Per event group g
// (rows (g, c), channel fastest):
//
//   v[c, :]   = scale * irfft(X[c, :K] zero-padded to n_base/2 + 1, n = n_base)
//   amp[c]    = max_n |v[c, n]|
//   tts[c, n] = any(v >= hi over the last n_bins_hl bins)
//               & any(v <= lo over the last n_bins_hl bins)       (high_low)
//             | |v[c, n]| >= hi                                  (threshold)
//   ttt[n]    = sum_c any(tts[c, last n_bins_maj bins]) >= n_coinc
//   fired     = any_n ttt,  first = fired ? min{n : ttt[n]} : 0
//
// The irfft is numpy's (backward normalisation 1/n; Im of the DC bin, and of
// the Nyquist bin for even n, dropped). Comparisons are the strict >= / <= of
// ops/triggers.py, windows are left-zero-padded, and each sliding-window "any"
// is a prefix count (P[i] - P[i - w]) > 0, taken by a block-wide scan.
//
// What bounds it on the H100: bytes. The function reads each row's K complex
// bins once and writes three small outputs; at the headline shape (65536
// rows, K 816, n_base 2048) that is 428.6 MB in float32 (857 MB in float64),
// 0.128 ms (0.256 ms) at 3.35 TB/s, while its FFTs and trigger logic need
// ~5e9 FLOP, 0.08 ms at 67 TFLOP/s. (The TPU kernel's dense irfft matrix, 4.4e11 FLOP, fed the
// MXU; on the CUDA cores it made the kernel compute-bound at 35-70 ms.)
//
// The design: the trace is made by an inverse real FFT in shared memory
// (fft_common.cuh: the half-length complex Stockham FFT with the Hermitian
// pre-step, mixed radix 16/4/2/3/5/any prime, twiddles from a float64 host
// table), whose natural-order output IS the real trace, so the FFT's last
// stage writes the channel's trace slot directly. A group's C traces stay in
// shared memory for the trigger logic. Blocks are persistent and small (128
// threads, 4-6 resident per SM): the grid is as many blocks as fit on the
// card, at most one per group, and each block walks groups G/grid apart. The
// next row's spectrum is copied into shared memory with cp.async (16-byte
// copies where the row is aligned) as soon as the current row's pre-step has
// read the staging buffer, so it arrives during the current row's FFT stages
// and trigger logic. The trigger logic keeps each thread's samples in
// registers and pads its prefix-count array by a word every 32, so the
// threads' contiguous runs fall on distinct banks; that array shares its
// memory with the FFT's ping-pong buffer, used only before it. Groups whose
// C traces do not fit shared memory are refused by the wrapper.

#include "fft_common.cuh"

namespace {

constexpr int NTH = 128;     // threads per block
constexpr int NWARP = NTH / 32;
// blocks per SM the registers must allow: 6 in float32 (<= 85 registers a
// thread), 4 in float64 (<= 128: the radix-16 stage holds 16 complex doubles)
template <typename T> constexpr int min_blocks() { return sizeof(T) == 4 ? 6 : 4; }
constexpr int EMAX_LARGE = 32;   // contiguous trigger samples per thread (n_base <= 4096)
constexpr int EMAX_SMALL = 16;   // the instantiation for n_base <= 2048
constexpr int TMAX = 4;      // triggers per launch
constexpr int KIND_HIGH_LOW = 0;

struct TriggerParams {
  int n;
  int kind[TMAX];
  int n_bins_hl[TMAX];
  int n_bins_maj[TMAX];
  int n_coinc[TMAX];
};

// exclusive block-wide prefix sum of one int per thread
__device__ int block_exclusive_scan(int x, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int ws = lane < NWARP ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, ws, o);
      if (lane >= o) ws += y;
    }
    if (lane < NWARP) warp_sums[lane] = ws;      // inclusive warp totals
  }
  __syncthreads();
  const int res = (wid > 0 ? warp_sums[wid - 1] : 0) + incl - x;
  __syncthreads();                                // warp_sums reusable
  return res;
}

template <typename T>
__device__ T block_max(T x, T* warp_buf) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  x = fftc::warp_max(x);
  if (lane == 0) warp_buf[wid] = x;
  __syncthreads();
  T m = warp_buf[0];
#pragma unroll
  for (int w = 1; w < NWARP; ++w) m = max(m, warp_buf[w]);
  __syncthreads();
  return m;
}

// shared-memory layout, each part 16-byte aligned:
//   trace [C][n_base] T | fft [max(fft buffers, P)] | stage [2][K] T | scratch
struct Layout {
  size_t trace, fft, stage, scratch, total;
};

template <typename T>
__host__ __device__ inline Layout layout_of(int C, int n_base, int K) {
  using T2 = typename fftc::Vec2<T>::type;
  Layout l;
  const size_t L = (n_base % 2 == 0) ? n_base / 2 : n_base;
  // n even: one L-point buffer besides the trace slot; n odd: two n-point ones
  const size_t fft_bytes = (n_base % 2 == 0) ? L * sizeof(T2) : 2 * L * sizeof(T2);
  const size_t p_bytes = (size_t)(n_base + n_base / 32 + 1) * sizeof(int);   // padded
  l.trace = 0;
  l.fft = fftc::align16((size_t)C * n_base * sizeof(T));
  l.stage = l.fft + fftc::align16(fft_bytes > p_bytes ? fft_bytes : p_bytes);
  l.scratch = l.stage + fftc::align16(2 * (size_t)K * sizeof(T));
  l.total = l.scratch + 32 * sizeof(T) + 32 * sizeof(int);
  return l;
}

// the prefix-count array is padded by one word every 32, so that the block's
// threads, each owning EMAX contiguous samples, hit distinct banks
__device__ __forceinline__ int pidx(int n) { return n + (n >> 5); }

// 16 bytes of the trace into registers
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  out[0] = q.x;
  out[1] = q.y;
  out[2] = q.z;
  out[3] = q.w;
}
__device__ __forceinline__ void load16(const double* p, double* out) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  out[0] = q.x;
  out[1] = q.y;
}

template <typename T, int EMAX>
__global__ void __launch_bounds__(NTH, min_blocks<T>()) irfft_trigger_kernel(
    const T* __restrict__ spec_re, const T* __restrict__ spec_im,
    const T* __restrict__ th_hi, const T* __restrict__ th_lo,
    const typename fftc::Vec2<T>::type* __restrict__ E,
    uint8_t* __restrict__ fired_out, int32_t* __restrict__ first_out,
    T* __restrict__ amp_out, int G, int C, int K, T norm,
    const __grid_constant__ fftc::Plan plan, const __grid_constant__ TriggerParams tp) {
  using T2 = typename fftc::Vec2<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int n_base = plan.n;
  const Layout lay = layout_of<T>(C, n_base, K);
  T* trace = reinterpret_cast<T*>(smem_raw + lay.trace);
  T2* fbuf = reinterpret_cast<T2*>(smem_raw + lay.fft);
  int* P = reinterpret_cast<int*>(smem_raw + lay.fft);      // shares fbuf's memory
  T* stage = reinterpret_cast<T*>(smem_raw + lay.stage);
  T* tscratch = reinterpret_cast<T*>(smem_raw + lay.scratch);
  int* iscratch = reinterpret_cast<int*>(tscratch + 32);
  const bool even = n_base % 2 == 0;

  // this block's rows, in order: (g, c) for g = blockIdx.x, + gridDim.x, ...
  int g = blockIdx.x;
  if (g >= G) return;
  auto fetch = [&](int row) {
    fftc::row_async(stage, spec_re + (size_t)row * K, K);
    fftc::row_async(stage + K, spec_im + (size_t)row * K, K);
    fftc::cp_async_commit();
  };
  fetch(g * C);

  for (; g < G; g += gridDim.x) {
    const int row0 = g * C;
    // ---- 1. the group's C traces into shared memory, one FFT per row -------
    for (int c = 0; c < C; ++c) {
      fftc::cp_async_wait_all();
      __syncthreads();                           // row arrived; traces free
      T2* slot = reinterpret_cast<T2*>(trace + (size_t)c * n_base);
      T2 *first, *other;
      if (even) {   // the last stage must land in the trace slot
        first = (plan.nst % 2 == 0) ? slot : fbuf;
        other = (plan.nst % 2 == 0) ? fbuf : slot;
      } else {
        first = fbuf;
        other = fbuf + plan.L;
      }
      fftc::fill(first, plan.L, fftc::IrfftIn<T, fftc::StagedRow<T>>{
                                    fftc::StagedRow<T>{stage, K}, K, n_base, plan.L, E, norm});
      // the staging buffer is read: the next row's copy into it starts
      const int next_g = (c + 1 < C) ? g : g + gridDim.x;
      const int next_c = (c + 1 < C) ? c + 1 : 0;
      if (next_g < G) fetch(next_g * C + next_c);
      T2* res = fftc::run<T, +1>(first, other, plan, E);
      if (!even) {                               // the trace is Re of the result
        for (int t = tid; t < n_base; t += NTH) trace[(size_t)c * n_base + t] = res[t].x;
        __syncthreads();
      }
    }

    // ---- 2. max |trace| per row ---------------------------------------------
    for (int r = 0; r < C; ++r) {
      const T* v = trace + (size_t)r * n_base;
      T m = T(0);
      for (int n = tid; n < n_base; n += NTH) m = max(m, abs(v[n]));
      m = block_max(m, tscratch);
      if (tid == 0) amp_out[row0 + r] = m;
    }

    // ---- 3. triggers: thread owns samples [e0, e0 + Es) ----------------------
    const int Es = (n_base + NTH - 1) / NTH;
    const int e0 = tid * Es;
    constexpr int V = 16 / sizeof(T);            // values per 16-byte load
    const bool vec = Es % V == 0 && n_base % V == 0;   // 16-byte aligned runs
    for (int t = 0; t < tp.n; ++t) {
      int cnt[EMAX];
#pragma unroll
      for (int e = 0; e < EMAX; ++e) cnt[e] = 0;
      for (int c = 0; c < C; ++c) {
        const T* v = trace + (size_t)c * n_base;
        T val[EMAX];                             // the thread's samples, in registers
        if (vec) {
#pragma unroll
          for (int e = 0; e < EMAX; e += V)
            if (e < Es) load16(v + e0 + e, val + e);
        } else {
#pragma unroll
          for (int e = 0; e < EMAX; ++e) val[e] = (e < Es && e0 + e < n_base) ? v[e0 + e] : T(0);
        }
        const T hi = th_hi[(size_t)(row0 + c) * tp.n + t];
        const T lo = th_lo[(size_t)(row0 + c) * tp.n + t];
        bool tts[EMAX];
        if (tp.kind[t] == KIND_HIGH_LOW) {
          // packed prefix count: hi crossings in bits 0-15, lo in 16-31
          int pref[EMAX];
          int run = 0;
#pragma unroll
          for (int e = 0; e < EMAX; ++e) {
            const int n = e0 + e;
            if (e < Es && n < n_base)
              run += (val[e] >= hi ? 1 : 0) + (val[e] <= lo ? (1 << 16) : 0);
            pref[e] = run;
          }
          const int off = block_exclusive_scan(run, iscratch);
#pragma unroll
          for (int e = 0; e < EMAX; ++e) {
            const int n = e0 + e;
            if (e < Es && n < n_base) P[pidx(n)] = off + pref[e];
          }
          __syncthreads();
          const int w = tp.n_bins_hl[t];
#pragma unroll
          for (int e = 0; e < EMAX; ++e) {
            const int n = e0 + e;
            tts[e] = false;
            if (e < Es && n < n_base) {
              const int d = off + pref[e] - (n >= w ? P[pidx(n - w)] : 0);
              tts[e] = ((d & 0xffff) > 0) && ((d >> 16) > 0);
            }
          }
          __syncthreads();                       // P reused below
        } else {
#pragma unroll
          for (int e = 0; e < EMAX; ++e) {
            const int n = e0 + e;
            tts[e] = (e < Es && n < n_base) ? (abs(val[e]) >= hi) : false;
          }
        }
        // widen over the majority window
        int pref[EMAX];
        int run = 0;
#pragma unroll
        for (int e = 0; e < EMAX; ++e) {
          run += tts[e] ? 1 : 0;
          pref[e] = run;
        }
        const int off = block_exclusive_scan(run, iscratch);
#pragma unroll
        for (int e = 0; e < EMAX; ++e) {
          const int n = e0 + e;
          if (e < Es && n < n_base) P[pidx(n)] = off + pref[e];
        }
        __syncthreads();
        const int wm = tp.n_bins_maj[t];
#pragma unroll
        for (int e = 0; e < EMAX; ++e) {
          const int n = e0 + e;
          if (e < Es && n < n_base)
            cnt[e] += (off + pref[e] - (n >= wm ? P[pidx(n - wm)] : 0)) > 0 ? 1 : 0;
        }
        __syncthreads();
      }
      int first = n_base;
#pragma unroll
      for (int e = EMAX - 1; e >= 0; --e) {
        const int n = e0 + e;
        if (e < Es && n < n_base && cnt[e] >= tp.n_coinc[t]) first = n;
      }
      first = fftc::block_min<NWARP>(first, iscratch);
      if (tid == 0) {
        const size_t o = (size_t)g * tp.n + t;
        fired_out[o] = first < n_base ? 1 : 0;
        first_out[o] = first < n_base ? first : 0;
      }
    }
  }
  fftc::cp_async_wait_all();
}

// blocks of one launch: as many as fit on the card, at most one per group
template <typename T, int EMAX>
cudaError_t grid_of(int G, size_t smem, int* n_blocks) {
  return fftc::persistent_grid(irfft_trigger_kernel<T, EMAX>, NTH, smem, G, n_blocks);
}

template <typename T, int EMAX>
int launch_with(const T* spec_re, const T* spec_im, const T* th_hi, const T* th_lo,
                const void* table, uint8_t* fired, int32_t* first, T* amp, int G, int C,
                int K, T norm, const fftc::Plan& plan, const TriggerParams& tp,
                void* stream) {
  using T2 = typename fftc::Vec2<T>::type;
  const size_t smem = layout_of<T>(C, plan.n, K).total;
  int n_blocks = 0;
  const cudaError_t err = grid_of<T, EMAX>(G, smem, &n_blocks);
  if (err != cudaSuccess) return (int)err;
  irfft_trigger_kernel<T, EMAX><<<n_blocks, NTH, smem, (cudaStream_t)stream>>>(
      spec_re, spec_im, th_hi, th_lo, static_cast<const T2*>(table), fired, first, amp, G,
      C, K, norm, plan, tp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* spec_re, const T* spec_im, const T* th_hi, const T* th_lo,
           const void* table, uint8_t* fired, int32_t* first, T* amp,
           const int* kinds, const int* n_bins_hl, const int* n_bins_maj,
           const int* n_coinc, int n_trig, int G, int C, int K, int n_base,
           const int* radix, int nst, T norm, void* stream) {
  if (n_trig < 1 || n_trig > TMAX || n_base > EMAX_LARGE * NTH || n_base < 2 || G < 1 ||
      C < 1 || K < 1 || K > n_base / 2 + 1)
    return (int)cudaErrorInvalidValue;
  const fftc::Plan plan = fftc::make_plan(n_base, radix, nst);
  if (!fftc::plan_ok(plan)) return (int)cudaErrorInvalidValue;
  TriggerParams tp;
  tp.n = n_trig;
  for (int t = 0; t < TMAX; ++t) {
    tp.kind[t] = t < n_trig ? kinds[t] : 0;
    tp.n_bins_hl[t] = t < n_trig ? n_bins_hl[t] : 1;
    tp.n_bins_maj[t] = t < n_trig ? n_bins_maj[t] : 1;
    tp.n_coinc[t] = t < n_trig ? n_coinc[t] : 1;
  }
  if (n_base <= EMAX_SMALL * NTH)
    return launch_with<T, EMAX_SMALL>(spec_re, spec_im, th_hi, th_lo, table, fired, first,
                                      amp, G, C, K, norm, plan, tp, stream);
  return launch_with<T, EMAX_LARGE>(spec_re, spec_im, th_hi, th_lo, table, fired, first, amp,
                                    G, C, K, norm, plan, tp, stream);
}

}  // namespace

extern "C" {

// limits and sizes the wrapper validates against before launching
int irfft_trigger_max_triggers() { return TMAX; }
int irfft_trigger_max_samples() { return EMAX_LARGE * NTH; }
long irfft_trigger_smem_bytes(int C, int n_base, int K, int f64) {
  return (long)(f64 ? layout_of<double>(C, n_base, K).total
                    : layout_of<float>(C, n_base, K).total);
}
// the grid a launch of these sizes uses (blocks), or -1
int irfft_trigger_grid(int G, int C, int n_base, int K, int f64) {
  int n = 0;
  cudaError_t err;
  const bool small = n_base <= EMAX_SMALL * NTH;
  if (f64) {
    const size_t smem = layout_of<double>(C, n_base, K).total;
    err = small ? grid_of<double, EMAX_SMALL>(G, smem, &n) : grid_of<double, EMAX_LARGE>(G, smem, &n);
  } else {
    const size_t smem = layout_of<float>(C, n_base, K).total;
    err = small ? grid_of<float, EMAX_SMALL>(G, smem, &n) : grid_of<float, EMAX_LARGE>(G, smem, &n);
  }
  return err == cudaSuccess ? n : -1;
}

int irfft_trigger_f32(const float* spec_re, const float* spec_im,
                      const float* th_hi, const float* th_lo, const void* table,
                      uint8_t* fired, int32_t* first, float* amp, const int* kinds,
                      const int* n_bins_hl, const int* n_bins_maj, const int* n_coinc,
                      int n_trig, int G, int C, int K, int n_base, const int* radix,
                      int nst, float norm, void* stream) {
  return launch<float>(spec_re, spec_im, th_hi, th_lo, table, fired, first, amp, kinds,
                       n_bins_hl, n_bins_maj, n_coinc, n_trig, G, C, K, n_base, radix, nst,
                       norm, stream);
}

int irfft_trigger_f64(const double* spec_re, const double* spec_im,
                      const double* th_hi, const double* th_lo, const void* table,
                      uint8_t* fired, int32_t* first, double* amp, const int* kinds,
                      const int* n_bins_hl, const int* n_bins_maj, const int* n_coinc,
                      int n_trig, int G, int C, int K, int n_base, const int* radix,
                      int nst, double norm, void* stream) {
  return launch<double>(spec_re, spec_im, th_hi, th_lo, table, fired, first, amp, kinds,
                        n_bins_hl, n_bins_maj, n_coinc, n_trig, G, C, K, n_base, radix,
                        nst, norm, stream);
}

}  // extern "C"
