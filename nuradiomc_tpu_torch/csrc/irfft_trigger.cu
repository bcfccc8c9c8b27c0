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
// stage writes the trace slot directly. Nothing in the function needs two
// traces at once, because the majority count is a sum over channels. So the
// channel loop is outermost: one row is transformed into the block's single
// trace slot, its max |v| is taken, and for every trigger its
// majority-widened bit is added into a per-(trigger, sample) count in shared
// memory (one byte a sample while C <= 255, two above). After the group's
// last channel one pass per trigger finds the first sample whose count
// reaches n_coinc. Shared memory is one trace, the FFT buffer, the staging
// rows and the counts, whatever C is. A channel whose threshold is +inf in a
// trigger's column (a channel outside that trigger's subset) is skipped
// there: it can never count.
//
// The trigger logic walks the trace in tiles of NTH * EMAX samples, each
// thread owning a contiguous run of a tile, so n_base is bounded only by the
// shared memory of one trace and its FFT buffer. The prefix array P is as
// long as the trace (a window looks back across tiles) and padded by a word
// every 32, so the threads' runs fall on distinct banks; it shares its memory
// with the FFT's ping-pong buffer, which is idle between a row's transform
// and the next row's. Where the trace is one tile (n_base <= 2048, the paths'
// length) a second instantiation keeps the thread's samples, prefixes and
// window bits in registers across a row's triggers and writes P once per
// window: the tiled form's extra passes over P cost 18-25% at the headline
// shape (NVIDIA H100 80GB HBM3, 700 W). Up to TMAX triggers go in one launch, as far as their
// counts fit shared memory; the wrapper slices a longer list over launches of
// this same kernel.
//
// What was hard there. The counts must outlive the next row's FFT, so they
// have a region of their own (one counter a trigger and sample) and are laid
// out sample-major per thread within a tile (cnt[k * tile + e * NTH + tid]):
// adjacent threads touch adjacent counters, conflict-free without padding,
// while P goes on sharing the FFT buffer. A window looks back across tiles,
// so each tile's block-wide prefix adds the carried total of the tiles
// before it, and the high/low bits replace the prefix in place from the last
// tile down, where no later tile still needs the prefix they overwrite.
//
// Blocks are persistent and small (128 threads, 4-6 resident per SM): the
// grid is as many blocks as fit on the card, at most one per group, and each
// block walks groups G/grid apart. The next row's spectrum is copied into
// shared memory with cp.async (16-byte copies where the row is aligned) as
// soon as the current row's pre-step has read the staging buffer, so it
// arrives during the current row's FFT stages and trigger logic.

#include "fft_common.cuh"

#include <cmath>
#include <type_traits>

namespace {

constexpr int NTH = 128;     // threads per block
constexpr int NWARP = NTH / 32;
// blocks per SM the registers must allow: 6 in float32 (<= 85 registers a
// thread), 4 in float64 (<= 128: the radix-16 stage holds 16 complex doubles)
template <typename T> constexpr int min_blocks() { return sizeof(T) == 4 ? 6 : 4; }
constexpr int EMAX = 16;     // contiguous trigger samples per thread and tile
constexpr int TMAX = 16;     // triggers per launch
constexpr int KIND_HIGH_LOW = 0;

struct TriggerParams {
  int n;          // triggers of this launch
  int t0;         // their first column in th_hi / th_lo / fired / first
  int stride;     // columns of those arrays
  int kind[TMAX];
  int n_bins_hl[TMAX];
  int n_bins_maj[TMAX];
  int n_coinc[TMAX];
};

// exclusive block-wide prefix sum of one int per thread; *total = the block's sum
__device__ int block_exclusive_scan(int x, int* warp_sums, int* total) {
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
  *total = warp_sums[NWARP - 1];
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

// the trace in tiles: a thread owns Es contiguous samples of each tile
struct Tiling {
  int Es, tile, n_tiles, n_pad;
};

__host__ __device__ inline Tiling tiling_of(int n_base) {
  Tiling t;
  const int per = (n_base + NTH - 1) / NTH;
  t.Es = per < EMAX ? per : EMAX;
  t.tile = t.Es * NTH;
  t.n_tiles = (n_base + t.tile - 1) / t.tile;
  t.n_pad = t.n_tiles * t.tile;
  return t;
}

// shared-memory layout, each part 16-byte aligned:
//   trace [n_base] T | fft [max(fft buffers, P)] | stage [2][K] T
//   | counts [n_trig][n_pad] | scratch
struct Layout {
  size_t trace, fft, stage, counts, scratch, total;
};

template <typename T>
__host__ __device__ inline Layout layout_of(int n_base, int K, int n_trig, int count_bytes) {
  using T2 = typename fftc::Vec2<T>::type;
  Layout l;
  const size_t L = (n_base % 2 == 0) ? n_base / 2 : n_base;
  // n even: one L-point buffer besides the trace slot; n odd: two n-point ones
  const size_t fft_bytes = (n_base % 2 == 0) ? L * sizeof(T2) : 2 * L * sizeof(T2);
  const size_t p_bytes = (size_t)(n_base + n_base / 32 + 1) * sizeof(int);   // padded
  l.trace = 0;
  l.fft = fftc::align16((size_t)n_base * sizeof(T));
  l.stage = l.fft + fftc::align16(fft_bytes > p_bytes ? fft_bytes : p_bytes);
  l.counts = l.stage + fftc::align16(2 * (size_t)K * sizeof(T));
  l.scratch = l.counts + fftc::align16((size_t)n_trig * tiling_of(n_base).n_pad * count_bytes);
  l.total = l.scratch + 32 * sizeof(T) + 32 * sizeof(int);
  return l;
}

// the prefix array is padded by one word every 32, so that the block's
// threads, each owning a contiguous run of samples, hit distinct banks
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

// the thread's Es samples from e0 on into registers (zeros past the trace),
// by 16-byte loads where its runs are aligned
template <typename T>
__device__ __forceinline__ void load_run(const T* trace, int e0, int Es, int n_base, bool vec,
                                         T* val) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
#pragma unroll
    for (int e = 0; e < EMAX; e += V)
      if (e < Es) load16(trace + e0 + e, val + e);
  } else {
#pragma unroll
    for (int e = 0; e < EMAX; ++e) val[e] = (e < Es && e0 + e < n_base) ? trace[e0 + e] : T(0);
  }
}

// the row's bit in one trigger's count where the trace is one tile: the
// thread's samples, prefixes and window bits stay in registers, and P is
// written once per window
template <typename T, typename CT>
__device__ __forceinline__ void count_row_one_tile(const T* val, T hi, T lo, bool high_low,
                                                   int w, int wm, int Es, int n_base, int* P,
                                                   int* iscratch, CT* cnt) {
  const int tid = threadIdx.x;
  const int e0 = tid * Es;
  bool tts[EMAX];
  int pref[EMAX];
  int total;
  if (high_low) {
    // packed prefix count: hi crossings in bits 0-15, lo crossings in bits 16-31
    int run = 0;
#pragma unroll
    for (int e = 0; e < EMAX; ++e) {
      if (e < Es && e0 + e < n_base)
        run += (val[e] >= hi ? 1 : 0) + (val[e] <= lo ? (1 << 16) : 0);
      pref[e] = run;
    }
    const int off = block_exclusive_scan(run, iscratch, &total);
#pragma unroll
    for (int e = 0; e < EMAX; ++e) {
      const int n = e0 + e;
      if (e < Es && n < n_base) P[pidx(n)] = off + pref[e];
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < EMAX; ++e) {
      const int n = e0 + e;
      tts[e] = false;
      if (e < Es && n < n_base) {
        const int d = off + pref[e] - (n >= w ? P[pidx(n - w)] : 0);
        tts[e] = ((d & 0xffff) > 0) && ((d >> 16) > 0);
      }
    }
    __syncthreads();                             // P reused below
  } else {
#pragma unroll
    for (int e = 0; e < EMAX; ++e)
      tts[e] = (e < Es && e0 + e < n_base) ? (abs(val[e]) >= hi) : false;
  }
  // widen over the majority window
  int run = 0;
#pragma unroll
  for (int e = 0; e < EMAX; ++e) {
    run += tts[e] ? 1 : 0;
    pref[e] = run;
  }
  const int off = block_exclusive_scan(run, iscratch, &total);
#pragma unroll
  for (int e = 0; e < EMAX; ++e) {
    const int n = e0 + e;
    if (e < Es && n < n_base) P[pidx(n)] = off + pref[e];
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < EMAX; ++e) {
    const int n = e0 + e;
    if (e < Es && n < n_base && off + pref[e] - (n >= wm ? P[pidx(n - wm)] : 0) > 0)
      cnt[e * NTH + tid] += 1;                   // threads adjacent: no bank conflict
  }
  __syncthreads();                               // P is read: free for the next use
}

// CT: the type of a per-sample channel count (uint8_t while C <= 255).
// ONE_TILE: the trace is one tile (n_base <= NTH * EMAX, the paths' 2048), so a
// thread holds all its samples in registers across a row's triggers
template <typename T, typename CT, bool ONE_TILE>
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
  const Layout lay = layout_of<T>(n_base, K, tp.n, (int)sizeof(CT));
  const Tiling til = tiling_of(n_base);
  T* trace = reinterpret_cast<T*>(smem_raw + lay.trace);
  T2* fbuf = reinterpret_cast<T2*>(smem_raw + lay.fft);
  int* P = reinterpret_cast<int*>(smem_raw + lay.fft);      // shares fbuf's memory
  T* stage = reinterpret_cast<T*>(smem_raw + lay.stage);
  CT* counts = reinterpret_cast<CT*>(smem_raw + lay.counts);
  T* tscratch = reinterpret_cast<T*>(smem_raw + lay.scratch);
  int* iscratch = reinterpret_cast<int*>(tscratch + 32);
  const bool even = n_base % 2 == 0;
  const int Es = til.Es;
  // every run of every tile is whole and 16-byte aligned
  const bool vec = Es % (16 / (int)sizeof(T)) == 0 && n_base % til.tile == 0;

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
    {  // no channel has counted yet (whole words: n_pad is a multiple of 128)
      uint32_t* w = reinterpret_cast<uint32_t*>(counts);
      const int n_words = (int)((size_t)tp.n * til.n_pad * sizeof(CT) / 4);
      for (int i = tid; i < n_words; i += NTH) w[i] = 0u;
    }
    for (int c = 0; c < C; ++c) {
      // ---- 1. the row's trace into the trace slot, by one FFT ---------------
      fftc::cp_async_wait_all();
      __syncthreads();                           // row arrived; trace and P free
      T2* slot = reinterpret_cast<T2*>(trace);
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
        for (int t = tid; t < n_base; t += NTH) trace[t] = res[t].x;
        __syncthreads();
      }

      if constexpr (ONE_TILE) {
        // ---- 2+3. the thread's samples once, for the maximum and every trigger -
        T val[EMAX];
        load_run(trace, tid * Es, Es, n_base, vec, val);
        T m = T(0);
#pragma unroll
        for (int e = 0; e < EMAX; ++e)
          if (e < Es && tid * Es + e < n_base) m = max(m, abs(val[e]));
        m = block_max(m, tscratch);
        if (tid == 0) amp_out[row0 + c] = m;
        for (int t = 0; t < tp.n; ++t) {
          const T hi = th_hi[(size_t)(row0 + c) * tp.stride + tp.t0 + t];
          const T lo = th_lo[(size_t)(row0 + c) * tp.stride + tp.t0 + t];
          if (hi > T(0) && isinf(hi)) continue;  // never over threshold: no count
          count_row_one_tile(val, hi, lo, tp.kind[t] == KIND_HIGH_LOW, tp.n_bins_hl[t],
                             tp.n_bins_maj[t], Es, n_base, P, iscratch,
                             counts + (size_t)t * til.n_pad);
        }
      } else {
        // ---- 2. max |trace| of the row -----------------------------------------
        {
          T m = T(0);
          for (int n = tid; n < n_base; n += NTH) m = max(m, abs(trace[n]));
          m = block_max(m, tscratch);
          if (tid == 0) amp_out[row0 + c] = m;
        }

        // ---- 3. the row's bit in every trigger's count -------------------------
        // thread owns samples [k * tile + tid * Es, + Es) of tile k; a window
        // looks back into earlier tiles through P, which spans the trace
        for (int t = 0; t < tp.n; ++t) {
          const T hi = th_hi[(size_t)(row0 + c) * tp.stride + tp.t0 + t];
          const T lo = th_lo[(size_t)(row0 + c) * tp.stride + tp.t0 + t];
          if (hi > T(0) && isinf(hi)) continue;    // never over threshold: no count
          if (tp.kind[t] == KIND_HIGH_LOW) {
            // packed prefix count over the trace: hi crossings in bits 0-15,
            // lo crossings in bits 16-31
            int carry = 0;
            for (int k = 0; k < til.n_tiles; ++k) {
              const int e0 = k * til.tile + tid * Es;
              T val[EMAX];
              load_run(trace, e0, Es, n_base, vec, val);
              int pref[EMAX];
              int run = 0;
  #pragma unroll
              for (int e = 0; e < EMAX; ++e) {
                if (e < Es && e0 + e < n_base)
                  run += (val[e] >= hi ? 1 : 0) + (val[e] <= lo ? (1 << 16) : 0);
                pref[e] = run;
              }
              int total;
              const int off = carry + block_exclusive_scan(run, iscratch, &total);
              carry += total;
  #pragma unroll
              for (int e = 0; e < EMAX; ++e) {
                const int n = e0 + e;
                if (e < Es && n < n_base) P[pidx(n)] = off + pref[e];
              }
            }
            __syncthreads();
            // tts in place of the prefix, last tile first: a tile reads its own
            // and earlier entries only, which still hold the prefix
            const int w = tp.n_bins_hl[t];
            for (int k = til.n_tiles - 1; k >= 0; --k) {
              const int e0 = k * til.tile + tid * Es;
              bool tts[EMAX];
  #pragma unroll
              for (int e = 0; e < EMAX; ++e) {
                const int n = e0 + e;
                tts[e] = false;
                if (e < Es && n < n_base) {
                  const int d = P[pidx(n)] - (n >= w ? P[pidx(n - w)] : 0);
                  tts[e] = ((d & 0xffff) > 0) && ((d >> 16) > 0);
                }
              }
              __syncthreads();                     // the tile is read
  #pragma unroll
              for (int e = 0; e < EMAX; ++e) {
                const int n = e0 + e;
                if (e < Es && n < n_base) P[pidx(n)] = tts[e] ? 1 : 0;
              }
            }
          } else {
            for (int k = 0; k < til.n_tiles; ++k) {
              const int e0 = k * til.tile + tid * Es;
              T val[EMAX];
              load_run(trace, e0, Es, n_base, vec, val);
  #pragma unroll
              for (int e = 0; e < EMAX; ++e) {
                const int n = e0 + e;
                if (e < Es && n < n_base) P[pidx(n)] = abs(val[e]) >= hi ? 1 : 0;
              }
            }
          }
          // widen over the majority window: prefix of tts in place (each
          // thread reads and writes its own entries), then the window's count
          int carry = 0;
          for (int k = 0; k < til.n_tiles; ++k) {
            const int e0 = k * til.tile + tid * Es;
            int pref[EMAX];
            int run = 0;
  #pragma unroll
            for (int e = 0; e < EMAX; ++e) {
              const int n = e0 + e;
              if (e < Es && n < n_base) run += P[pidx(n)];
              pref[e] = run;
            }
            int total;
            const int off = carry + block_exclusive_scan(run, iscratch, &total);
            carry += total;
  #pragma unroll
            for (int e = 0; e < EMAX; ++e) {
              const int n = e0 + e;
              if (e < Es && n < n_base) P[pidx(n)] = off + pref[e];
            }
          }
          __syncthreads();
          const int wm = tp.n_bins_maj[t];
          CT* cnt = counts + (size_t)t * til.n_pad;
          for (int k = 0; k < til.n_tiles; ++k) {
            const int e0 = k * til.tile + tid * Es;
  #pragma unroll
            for (int e = 0; e < EMAX; ++e) {
              const int n = e0 + e;
              if (e < Es && n < n_base) {
                const int d = P[pidx(n)] - (n >= wm ? P[pidx(n - wm)] : 0);
                // the thread's sample e of tile k, threads adjacent: no bank conflict
                if (d > 0) cnt[k * til.tile + e * NTH + tid] += 1;
              }
            }
          }
          __syncthreads();                         // P is read: free for the next use
        }
      }
    }

    // ---- 4. per trigger, the first sample with enough channels ---------------
    for (int t = 0; t < tp.n; ++t) {
      const CT* cnt = counts + (size_t)t * til.n_pad;
      const int need = tp.n_coinc[t];
      int first = n_base;
      for (int k = til.n_tiles - 1; k >= 0; --k) {
#pragma unroll
        for (int e = EMAX - 1; e >= 0; --e) {
          const int n = k * til.tile + tid * Es + e;
          if (e < Es && n < n_base && (int)cnt[k * til.tile + e * NTH + tid] >= need) first = n;
        }
      }
      first = fftc::block_min<NWARP>(first, iscratch);
      if (tid == 0) {
        const size_t o = (size_t)g * tp.stride + tp.t0 + t;
        fired_out[o] = first < n_base ? 1 : 0;
        first_out[o] = first < n_base ? first : 0;
      }
    }
    __syncthreads();                             // the counts are read
  }
  fftc::cp_async_wait_all();
}

// blocks of one launch: as many as fit on the card, at most one per group
template <typename T, typename CT, bool ONE_TILE>
cudaError_t grid_of(int G, size_t smem, int* n_blocks) {
  return fftc::persistent_grid(irfft_trigger_kernel<T, CT, ONE_TILE>, NTH, smem, G, n_blocks);
}

// the instantiation a launch uses: one tile and one-byte counts where both
// hold (the paths' shapes), else the tiled form with the count type C needs
template <typename T, typename F>
auto dispatch(int C, int n_base, F&& f) {
  if (C <= 255 && tiling_of(n_base).n_tiles == 1)
    return f(std::integral_constant<bool, true>{}, uint8_t{});
  if (C <= 255) return f(std::integral_constant<bool, false>{}, uint8_t{});
  return f(std::integral_constant<bool, false>{}, uint16_t{});
}

template <typename T, typename CT, bool ONE_TILE>
int launch_with(const T* spec_re, const T* spec_im, const T* th_hi, const T* th_lo,
                const void* table, uint8_t* fired, int32_t* first, T* amp, int G, int C,
                int K, T norm, const fftc::Plan& plan, const TriggerParams& tp,
                void* stream) {
  using T2 = typename fftc::Vec2<T>::type;
  const size_t smem = layout_of<T>(plan.n, K, tp.n, (int)sizeof(CT)).total;
  int n_blocks = 0;
  const cudaError_t err = grid_of<T, CT, ONE_TILE>(G, smem, &n_blocks);
  if (err != cudaSuccess) return (int)err;
  irfft_trigger_kernel<T, CT, ONE_TILE><<<n_blocks, NTH, smem, (cudaStream_t)stream>>>(
      spec_re, spec_im, th_hi, th_lo, static_cast<const T2*>(table), fired, first, amp, G,
      C, K, norm, plan, tp);
  return (int)cudaGetLastError();
}

// launches triggers [t0, t0 + n_trig) of the n_total columns
template <typename T>
int launch(const T* spec_re, const T* spec_im, const T* th_hi, const T* th_lo,
           const void* table, uint8_t* fired, int32_t* first, T* amp,
           const int* kinds, const int* n_bins_hl, const int* n_bins_maj,
           const int* n_coinc, int n_trig, int t0, int n_total, int G, int C, int K,
           int n_base, const int* radix, int nst, T norm, void* stream) {
  if (n_trig < 0 || n_trig > TMAX || t0 < 0 || t0 + n_trig > n_total || n_base < 2 ||
      n_base > 0xffff || G < 1 || C < 1 || C > 0xffff || K < 1 || K > n_base / 2 + 1)
    return (int)cudaErrorInvalidValue;
  const fftc::Plan plan = fftc::make_plan(n_base, radix, nst);
  if (!fftc::plan_ok(plan)) return (int)cudaErrorInvalidValue;
  TriggerParams tp;
  tp.n = n_trig;
  tp.t0 = t0;
  tp.stride = n_total;
  for (int t = 0; t < TMAX; ++t) {
    tp.kind[t] = t < n_trig ? kinds[t] : 0;
    tp.n_bins_hl[t] = t < n_trig ? n_bins_hl[t] : 1;
    tp.n_bins_maj[t] = t < n_trig ? n_bins_maj[t] : 1;
    tp.n_coinc[t] = t < n_trig ? n_coinc[t] : 1;
  }
  return dispatch<T>(C, n_base, [&](auto one_tile, auto count) {
    return launch_with<T, decltype(count), decltype(one_tile)::value>(
        spec_re, spec_im, th_hi, th_lo, table, fired, first, amp, G, C, K, norm, plan, tp,
        stream);
  });
}

}  // namespace

extern "C" {

// limits and sizes the wrapper validates against before launching
int irfft_trigger_max_triggers() { return TMAX; }
// bytes of shared memory of a block with n_trig triggers in the launch
long irfft_trigger_smem_bytes(int C, int n_base, int K, int n_trig, int f64) {
  const int cb = C <= 255 ? 1 : 2;
  return (long)(f64 ? layout_of<double>(n_base, K, n_trig, cb).total
                    : layout_of<float>(n_base, K, n_trig, cb).total);
}
// the grid a launch of these sizes uses (blocks), or -1
int irfft_trigger_grid(int G, int C, int n_base, int K, int n_trig, int f64) {
  int n = 0;
  const size_t smem = (size_t)irfft_trigger_smem_bytes(C, n_base, K, n_trig, f64);
  cudaError_t err;
  if (f64)
    err = dispatch<double>(C, n_base, [&](auto one_tile, auto count) {
      return grid_of<double, decltype(count), decltype(one_tile)::value>(G, smem, &n);
    });
  else
    err = dispatch<float>(C, n_base, [&](auto one_tile, auto count) {
      return grid_of<float, decltype(count), decltype(one_tile)::value>(G, smem, &n);
    });
  return err == cudaSuccess ? n : -1;
}

int irfft_trigger_f32(const float* spec_re, const float* spec_im,
                      const float* th_hi, const float* th_lo, const void* table,
                      uint8_t* fired, int32_t* first, float* amp, const int* kinds,
                      const int* n_bins_hl, const int* n_bins_maj, const int* n_coinc,
                      int n_trig, int t0, int n_total, int G, int C, int K, int n_base,
                      const int* radix, int nst, float norm, void* stream) {
  return launch<float>(spec_re, spec_im, th_hi, th_lo, table, fired, first, amp, kinds,
                       n_bins_hl, n_bins_maj, n_coinc, n_trig, t0, n_total, G, C, K, n_base,
                       radix, nst, norm, stream);
}

int irfft_trigger_f64(const double* spec_re, const double* spec_im,
                      const double* th_hi, const double* th_lo, const void* table,
                      uint8_t* fired, int32_t* first, double* amp, const int* kinds,
                      const int* n_bins_hl, const int* n_bins_maj, const int* n_coinc,
                      int n_trig, int t0, int n_total, int G, int C, int K, int n_base,
                      const int* radix, int nst, double norm, void* stream) {
  return launch<double>(spec_re, spec_im, th_hi, th_lo, table, fired, first, amp, kinds,
                        n_bins_hl, n_bins_maj, n_coinc, n_trig, t0, n_total, G, C, K,
                        n_base, radix, nst, norm, stream);
}

}  // extern "C"
