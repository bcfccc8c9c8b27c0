// The placement epilogue of placement_reduce.cu (kernel 4): the dense
// placement DFT of V rows staged in shared memory, the sub-bin phase ramp and
// the (shower, ray) reduction. (Kernel 1, placement_chain.cu, places by FFT
// since it was redesigned; moving kernel 4 onto that FFT core is queued.)
//
//   Xb[r, k]  = Re(V[r, :]) @ D_r[:, k] + Im(V[r, :]) @ D_i[:, k]      (complex)
//   out[g, k] = sum_{j < s2} Xb[g*s2 + j, k] * exp(-2 pi i k df offset[g*s2 + j])
//
// A block owns KT output columns (one per thread) and a run of output rows.
// Their s2 input rows each are staged RB at a time (one "chunk", f-major in
// shared memory); each thread keeps the chunk's RB rows of Xb in registers and
// carries the (shower, ray) sum in registers from chunk to chunk, so any s2
// works and no atomics are needed (the result is deterministic). When s2 <= RB
// a block owns RB / s2 output rows and runs one chunk; otherwise it owns the
// least number of output rows whose input rows fill whole chunks,
// RB / gcd(s2, RB), so no staged row is wasted.
//
// The phase follows trace.time_shift_phase_uniform's factorization
// k = 32a + b, w^k = e^{i theta 32a} e^{i theta b} with theta = c * offset and
// c = -2 pi df rounded to T, so the kernel evaluates the same arguments as the
// plain version.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace placement {

constexpr int KT = 128;   // output columns per block == threads per block

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

__device__ inline void sincos_t(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ inline void sincos_t(double x, double* s, double* c) { sincos(x, s, c); }

// output rows per block (see the note above); the launcher sizes the grid by it
__host__ __device__ inline int out_rows_per_block(int s2, int rb) {
  if (s2 <= rb) return rb / s2;
  int a = s2, b = rb;
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return rb / a;
}

// One block's share of the placement. ``stage(V, row0, n)`` fills V
// [K_int][RB] (f-major) with input rows row0 .. row0 + n - 1 and zeros for the
// rows past n; kPhase = false drops the phase ramp (the profiling variant).
template <typename T, int RB, bool kPhase, typename Stage>
__device__ inline void place_block(
    const Stage& stage, typename Vec2<T>::type* V, const T* __restrict__ offsets,
    const T* __restrict__ drr, const T* __restrict__ dri,
    const T* __restrict__ dir_, const T* __restrict__ dii,
    T* __restrict__ out_re, T* __restrict__ out_im,
    int R, int s2, int K_int, int K_place, T theta_c) {
  using T2 = typename Vec2<T>::type;
  const int gpb = out_rows_per_block(s2, RB);
  const int G_out = R / s2;
  const int g0 = blockIdx.x * gpb;
  const int n_out = min(gpb, G_out - g0);
  const int rows = n_out * s2;
  const int r0 = g0 * s2;
  const int k = blockIdx.y * KT + threadIdx.x;
  const bool k_ok = k < K_place;
  const int kk = k_ok ? k : 0;
  const int a32 = (k / 32) * 32;
  const int b = k - a32;
  T acc_r = T(0), acc_i = T(0);

  for (int cs = 0; cs < rows; cs += RB) {
    if (cs > 0) __syncthreads();               // the last chunk's reads are done
    stage(V, r0 + cs, min(RB, rows - cs));
    __syncthreads();

    // placement DFT: Xb[r, k] for the chunk's rows, column k per thread
    T xr[RB], xi[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      xr[r] = T(0);
      xi[r] = T(0);
    }
    T d0 = drr[kk], d1 = dri[kk], d2 = dir_[kk], d3 = dii[kk];
    for (int f = 0; f < K_int; ++f) {
      T n0 = T(0), n1 = T(0), n2 = T(0), n3 = T(0);
      if (f + 1 < K_int) {                     // prefetch the next D row
        const size_t o = (size_t)(f + 1) * K_place + kk;
        n0 = drr[o];
        n1 = dri[o];
        n2 = dir_[o];
        n3 = dii[o];
      }
      const T2* Vf = V + f * RB;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const T2 v = Vf[r];
        xr[r] += v.x * d0 + v.y * d2;
        xi[r] += v.x * d1 + v.y * d3;
      }
      d0 = n0;
      d1 = n1;
      d2 = n2;
      d3 = n3;
    }

    // phase ramp and (shower, ray) reduction in registers
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int j = cs + r;
      if (j < rows) {
        if (kPhase) {
          const T theta = theta_c * offsets[r0 + j];
          T sa, ca, sb, cb;
          sincos_t(theta * T(a32), &sa, &ca);
          sincos_t(theta * T(b), &sb, &cb);
          const T pr = ca * cb - sa * sb;
          const T pi = ca * sb + sa * cb;
          acc_r += xr[r] * pr - xi[r] * pi;
          acc_i += xr[r] * pi + xi[r] * pr;
        } else {
          acc_r += xr[r];
          acc_i += xi[r];
        }
        if ((j + 1) % s2 == 0) {
          if (k_ok) {
            const size_t o = (size_t)(g0 + j / s2) * K_place + k;
            out_re[o] = acc_r;
            out_im[o] = acc_i;
          }
          acc_r = T(0);
          acc_i = T(0);
        }
      }
    }
  }
}

// grid of a placement launch: output-row blocks x column tiles
inline dim3 grid_of(int R, int s2, int K_place, int rb) {
  const int gpb = out_rows_per_block(s2, rb);
  const int G_out = R / s2;
  return dim3((G_out + gpb - 1) / gpb, (K_place + KT - 1) / KT);
}

}  // namespace placement
