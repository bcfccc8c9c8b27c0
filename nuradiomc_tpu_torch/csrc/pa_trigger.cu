// Fused phased-array trigger chain for Hopper (sm_90a): full irfft -> max
// amplitude; decimating irfft -> floor ADC with saturation -> FFT upsample
// -> static-roll coherent beams -> sliding power sums -> threshold on the
// frame grid -> fired and first frame.
//
// Replaces nuradiomc_tpu/ops/pa_pallas.py::fused_pa_trigger (pa_pallas.py:130,
// kernel _kernel, _sliding_sum_fwd). Per event group g (rows (g, c), channel
// fastest):
//
//   amp[c]    = max_n |scale_full * (Re X[c] @ I_r + Im X[c] @ I_i)[n]|
//   dec[c, k] = scale_dec * (Re X[c] @ Dd_r + Im X[c] @ Dd_i)[k]
//   q[c, k]   = (clip(floor((dec - v_min) / lsb), 0, n_counts - 1) + off) * lsb
//   up[c, m]  = (q[c] @ U)[m]
//   beam_b[m] = sum_c up[c, (m - roll[b, c]) mod n_up]       (torch.roll)
//   P_b[f]    = sum_{i < window} beam_b[f * step + i]^2 / window,
//               f < (n_up - window) / step
//   fired     = any_{b, f} P_b[f] > threshold,  frame = fired ? min f : 0
//
// The ADC divides by lsb, as ops/adc.py does; the products before it are
// rounded (__fmul_rn) so no FMA contraction changes the count boundaries
// against the plain version. Beams add channels in the plain version's
// order; only the window sum (direct here, a cumsum difference there) and
// the matmul summation order differ.
//
// What bounds it on the H100: the three products are 4, 4 and 2 FLOP per
// (row, k, n); at the bench shape (65536 rows, K 512, n_base 2048, n_dec 512,
// n_up 1024) that is ~4.1e11 FLOP of plain FMA, compute-bound against the
// CUDA cores (67 TFLOP/s FP32, 34 FP64); the beams and power sums are
// O(B * n_up * window) per group. The design keeps every trace of the chain
// on chip: the full-rate trace lives only in registers as a running max, the
// quantized and upsampled traces of a block's groups in shared memory. A
// block owns whole groups (the beams sum channels), computes up to RBMAX
// rows at once so each matrix element read from L2 feeds 2 * RBMAX FMAs,
// holds RBMAX x SPT accumulators per thread, and stages the spectra through
// shared memory in tiles of FT frequencies. U (2 MB in f32) is read from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTH = 256;     // threads per block
constexpr int NWARP = NTH / 32;
constexpr int SPT = 4;       // output columns per thread per chunk
constexpr int FT = 32;       // frequencies per staged spectrum tile

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// acc[r][s] = sum_f Re X[row0 + r, f] * Mr[f, n] + Im X[row0 + r, f] * Mi[f, n]
// for n = n0 + s * NTH + tid < N and rows r < nr (others stay 0).
template <typename T, int RB>
__device__ void spectrum_matmul(const T* __restrict__ spec_re,
                                const T* __restrict__ spec_im, size_t row0,
                                int nr, int K, const T* __restrict__ Mr,
                                const T* __restrict__ Mi, int N, int n0,
                                typename Vec2<T>::type* S, T (&acc)[RB][SPT]) {
  using T2 = typename Vec2<T>::type;
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int s = 0; s < SPT; ++s) acc[r][s] = T(0);
  for (int f0 = 0; f0 < K; f0 += FT) {
    __syncthreads();                             // previous tile consumed
    for (int i = tid; i < RB * FT; i += NTH) {
      const int r = i / FT;
      const int ff = i - r * FT;
      T2 v;
      v.x = T(0);
      v.y = T(0);
      if (r < nr && f0 + ff < K) {
        const size_t o = (row0 + r) * (size_t)K + f0 + ff;
        v.x = spec_re[o];
        v.y = spec_im[o];
      }
      S[ff * RB + r] = v;
    }
    __syncthreads();
    const int fmax = min(FT, K - f0);
    for (int ff = 0; ff < fmax; ++ff) {
      const size_t base = (size_t)(f0 + ff) * N;
      T mr[SPT], mi[SPT];
#pragma unroll
      for (int s = 0; s < SPT; ++s) {
        const int n = n0 + s * NTH + tid;
        mr[s] = n < N ? Mr[base + n] : T(0);
        mi[s] = n < N ? Mi[base + n] : T(0);
      }
      const T2* Sf = S + ff * RB;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const T2 v = Sf[r];
#pragma unroll
        for (int s = 0; s < SPT; ++s) acc[r][s] += v.x * mr[s] + v.y * mi[s];
      }
    }
  }
}

struct PaParams {
  int G, C, K, n_base, n_dec, n_up, B, window, step, gpb, n_counts;
};

template <typename T>
struct PaScalars {
  T scale_full, scale_dec, threshold, v_min, lsb, offset;
};

// smem layout: spec tile [FT][RBMAX] T2 | dec [rows][n_dec] T |
//              up [rows][n_up] T | max scratch [NWARP][RBMAX] T |
//              rolls [B][C] int | first frame [gpb] int
template <typename T, int RBMAX>
__global__ void __launch_bounds__(NTH) pa_trigger_kernel(
    const T* __restrict__ spec_re, const T* __restrict__ spec_im,
    const T* __restrict__ I_r, const T* __restrict__ I_i,
    const T* __restrict__ Dd_r, const T* __restrict__ Dd_i,
    const T* __restrict__ U, const int* __restrict__ rolls,
    uint8_t* __restrict__ fired_out, int32_t* __restrict__ frame_out,
    T* __restrict__ amp_out, PaParams p, PaScalars<T> sc) {
  using T2 = typename Vec2<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int C = p.C;
  const int g0 = blockIdx.x * p.gpb;
  const int n_g = min(p.gpb, p.G - g0);
  const int rows = n_g * C;
  const size_t row0 = (size_t)g0 * C;

  T2* S = reinterpret_cast<T2*>(smem_raw);
  T* dec = reinterpret_cast<T*>(S + FT * RBMAX);
  T* up = dec + (size_t)p.gpb * C * p.n_dec;
  T* red = up + (size_t)p.gpb * C * p.n_up;
  int* rolls_s = reinterpret_cast<int*>(red + NWARP * RBMAX);
  int* first_s = rolls_s + p.B * C;

  const int nf = (p.n_up - p.window) / p.step;    // frames on the grid
  for (int i = tid; i < p.B * C; i += NTH) rolls_s[i] = rolls[i];
  if (tid < p.gpb) first_s[tid] = nf;

  T acc[RBMAX][SPT];
  for (int rc = 0; rc < rows; rc += RBMAX) {
    const int nr = min(RBMAX, rows - rc);

    // ---- 1. full-rate trace: running max |trace| per row, never stored ----
    T mx[RBMAX];
#pragma unroll
    for (int r = 0; r < RBMAX; ++r) mx[r] = T(0);
    for (int n0 = 0; n0 < p.n_base; n0 += NTH * SPT) {
      spectrum_matmul<T, RBMAX>(spec_re, spec_im, row0 + rc, nr, p.K, I_r, I_i,
                                p.n_base, n0, S, acc);
#pragma unroll
      for (int r = 0; r < RBMAX; ++r)
#pragma unroll
        for (int s = 0; s < SPT; ++s) mx[r] = max(mx[r], abs(mul_rn(acc[r][s], sc.scale_full)));
    }
#pragma unroll
    for (int r = 0; r < RBMAX; ++r) {
      T m = mx[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_down_sync(0xffffffffu, m, o));
      if (lane == 0) red[wid * RBMAX + r] = m;
    }
    __syncthreads();
    if (tid < nr) {
      T m = red[tid];
      for (int w = 1; w < NWARP; ++w) m = max(m, red[w * RBMAX + tid]);
      amp_out[row0 + rc + tid] = m;
    }

    // ---- 2. decimated trace through the ADC, into shared memory ----------
    for (int n0 = 0; n0 < p.n_dec; n0 += NTH * SPT) {
      spectrum_matmul<T, RBMAX>(spec_re, spec_im, row0 + rc, nr, p.K, Dd_r, Dd_i,
                                p.n_dec, n0, S, acc);
#pragma unroll
      for (int r = 0; r < RBMAX; ++r) {
        if (r < nr) {
#pragma unroll
          for (int s = 0; s < SPT; ++s) {
            const int n = n0 + s * NTH + tid;
            if (n < p.n_dec) {
              const T tr = mul_rn(acc[r][s], sc.scale_dec);
              T c = floor((tr - sc.v_min) / sc.lsb);
              c = min(max(c, T(0)), T(p.n_counts - 1));
              dec[(size_t)(rc + r) * p.n_dec + n] = mul_rn(c + sc.offset, sc.lsb);
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- 3. upsample: up = q @ U, U read from L2 ------------------------------
  for (int rc = 0; rc < rows; rc += RBMAX) {
    const int nr = min(RBMAX, rows - rc);
    for (int m0 = 0; m0 < p.n_up; m0 += NTH * SPT) {
#pragma unroll
      for (int r = 0; r < RBMAX; ++r)
#pragma unroll
        for (int s = 0; s < SPT; ++s) acc[r][s] = T(0);
      for (int k = 0; k < p.n_dec; ++k) {
        T u[SPT];
#pragma unroll
        for (int s = 0; s < SPT; ++s) {
          const int m = m0 + s * NTH + tid;
          u[s] = m < p.n_up ? U[(size_t)k * p.n_up + m] : T(0);
        }
#pragma unroll
        for (int r = 0; r < RBMAX; ++r) {
          const T qv = r < nr ? dec[(size_t)(rc + r) * p.n_dec + k] : T(0);
#pragma unroll
          for (int s = 0; s < SPT; ++s) acc[r][s] += qv * u[s];
        }
      }
#pragma unroll
      for (int r = 0; r < RBMAX; ++r) {
        if (r < nr) {
#pragma unroll
          for (int s = 0; s < SPT; ++s) {
            const int m = m0 + s * NTH + tid;
            if (m < p.n_up) up[(size_t)(rc + r) * p.n_up + m] = acc[r][s];
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- 4. beams, window power sums, threshold, first frame ------------------
  const int pairs = p.B * nf;
  for (int gl = 0; gl < n_g; ++gl) {
    const T* upg = up + (size_t)gl * C * p.n_up;
    for (int q = tid; q < pairs; q += NTH) {
      const int b = q / nf;
      const int f = q - b * nf;
      const int start = f * p.step;
      T sum = T(0);
      for (int i = 0; i < p.window; ++i) {
        const int m = start + i;
        T v = T(0);
        for (int c = 0; c < C; ++c) {
          int idx = m - rolls_s[b * C + c];
          if (idx < 0) idx += p.n_up;
          v += upg[(size_t)c * p.n_up + idx];
        }
        sum += mul_rn(v, v);
      }
      if (sum / T(p.window) > sc.threshold) atomicMin(&first_s[gl], f);
    }
  }
  __syncthreads();
  if (tid < n_g) {
    const int f = first_s[tid];
    fired_out[g0 + tid] = f < nf ? 1 : 0;
    frame_out[g0 + tid] = f < nf ? f : 0;
  }
}

template <typename T, int RBMAX>
int launch(const T* spec_re, const T* spec_im, const T* I_r, const T* I_i,
           const T* Dd_r, const T* Dd_i, const T* U, const int* rolls,
           uint8_t* fired, int32_t* frame, T* amp, PaParams p, PaScalars<T> sc,
           void* stream) {
  using T2 = typename Vec2<T>::type;
  if (p.window < 1 || p.step < 1 || p.n_up < p.window || p.gpb < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)FT * RBMAX * sizeof(T2) +
                      (size_t)p.gpb * p.C * (p.n_dec + p.n_up) * sizeof(T) +
                      (size_t)NWARP * RBMAX * sizeof(T) +
                      (size_t)p.B * p.C * sizeof(int) + (size_t)p.gpb * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(pa_trigger_kernel<T, RBMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_blocks = (p.G + p.gpb - 1) / p.gpb;
  pa_trigger_kernel<T, RBMAX><<<n_blocks, NTH, smem, (cudaStream_t)stream>>>(
      spec_re, spec_im, I_r, I_i, Dd_r, Dd_i, U, rolls, fired, frame, amp, p, sc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// launch geometry the wrapper needs to size shared memory
int pa_trigger_rows_per_pass_f32() { return 16; }
int pa_trigger_rows_per_pass_f64() { return 8; }
int pa_trigger_spec_tile() { return FT; }

int pa_trigger_f32(const float* spec_re, const float* spec_im, const float* I_r,
                   const float* I_i, const float* Dd_r, const float* Dd_i,
                   const float* U, const int* rolls, uint8_t* fired,
                   int32_t* frame, float* amp, int G, int C, int K, int n_base,
                   int n_dec, int n_up, int B, int window, int step, int gpb,
                   int n_counts, float scale_full, float scale_dec,
                   float threshold, float v_min, float lsb, float offset,
                   void* stream) {
  const PaParams p = {G, C, K, n_base, n_dec, n_up, B, window, step, gpb, n_counts};
  const PaScalars<float> sc = {scale_full, scale_dec, threshold, v_min, lsb, offset};
  return launch<float, 16>(spec_re, spec_im, I_r, I_i, Dd_r, Dd_i, U, rolls,
                           fired, frame, amp, p, sc, stream);
}

int pa_trigger_f64(const double* spec_re, const double* spec_im,
                   const double* I_r, const double* I_i, const double* Dd_r,
                   const double* Dd_i, const double* U, const int* rolls,
                   uint8_t* fired, int32_t* frame, double* amp, int G, int C,
                   int K, int n_base, int n_dec, int n_up, int B, int window,
                   int step, int gpb, int n_counts, double scale_full,
                   double scale_dec, double threshold, double v_min, double lsb,
                   double offset, void* stream) {
  const PaParams p = {G, C, K, n_base, n_dec, n_up, B, window, step, gpb, n_counts};
  const PaScalars<double> sc = {scale_full, scale_dec, threshold, v_min, lsb, offset};
  return launch<double, 8>(spec_re, spec_im, I_r, I_i, Dd_r, Dd_i, U, rolls,
                           fired, frame, amp, p, sc, stream);
}

}  // extern "C"
