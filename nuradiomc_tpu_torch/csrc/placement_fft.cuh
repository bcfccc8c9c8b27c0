// Placement of one spectrum row by FFT, shared by the placement chain kernel
// (placement_chain.cu, kernel 1) and the placement kernel on a materialized
// voltage spectrum (placement_reduce.cu, kernel 4):
//
//   Xb[k]   = rfft(pad(irfft(V[:K_int], n_int), n_base))[k],      k < K_place
//   acc[k] += Xb[k] * exp(i theta k)             (theta = -2 pi df offset)
//
// by two FFTs in shared memory (fft_common.cuh): an inverse real FFT of
// length n_int (half-length complex Stockham with the Hermitian pre-step),
// whose packed output is already the forward transform's packed input, then
// a forward real FFT of length n_base of the zero-padded trace. They are
// numpy's irfft and rfft (Im of the DC bin, and of the Nyquist bin for even
// n_int, dropped; 1/n_int on the inverse only): the TPU kernels' dense
// placement matrices (pipeline._placement_matrices) are exactly this map.
// The phase follows trace.time_shift_phase_uniform's factorization k = 32a +
// b, w^k = e^{i theta 32a} e^{i theta b} with theta = c * offset and c =
// -2 pi df rounded to T, so the kernels evaluate the same arguments as the
// plain versions; the 32 + ceil(K_place/32) factors of a row are made once
// per row. Each thread owns the bins k = tid + j * blockDim.x of the
// accumulator, so rows are summed in order: no atomics, deterministic.

#pragma once

#include "fft_common.cuh"

namespace placefft {

constexpr int PB = 32;       // phase factorization block (trace.time_shift_phase_uniform)

using fftc::Vec2;

__device__ inline void sincos_t(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ inline void sincos_t(double x, double* s, double* c) { sincos(x, s, c); }

// the shared memory a row's placement works in, each part 16-byte aligned,
// from byte ``base`` on: A, B [max(L_int, L_base)] T2 | acc [K_place] T2 |
// wb [32] T2 | wa [ceil(K_place / 32)] T2
struct Layout {
  size_t A, B, acc, wb, wa, total;
};

template <typename T>
__host__ __device__ inline Layout layout_of(size_t base, int n_int, int n_base, int K_place) {
  using T2 = typename Vec2<T>::type;
  const int L1 = fftc::complex_length(n_int), L2 = fftc::complex_length(n_base);
  const size_t Lmax = L1 > L2 ? L1 : L2;
  Layout l;
  l.A = fftc::align16(base);
  l.B = l.A + fftc::align16(Lmax * sizeof(T2));
  l.acc = l.B + fftc::align16(Lmax * sizeof(T2));
  l.wb = l.acc + fftc::align16((size_t)K_place * sizeof(T2));
  l.wa = l.wb + fftc::align16(PB * sizeof(T2));
  l.total = l.wa + (size_t)((K_place + PB - 1) / PB) * sizeof(T2);
  return l;
}

template <typename T>
struct Work {
  typename Vec2<T>::type *A, *B, *acc, *wb, *wa;
  __device__ Work(unsigned char* smem, const Layout& l)
      : A(reinterpret_cast<typename Vec2<T>::type*>(smem + l.A)),
        B(reinterpret_cast<typename Vec2<T>::type*>(smem + l.B)),
        acc(reinterpret_cast<typename Vec2<T>::type*>(smem + l.acc)),
        wb(reinterpret_cast<typename Vec2<T>::type*>(smem + l.wb)),
        wa(reinterpret_cast<typename Vec2<T>::type*>(smem + l.wa)) {}
};

// acc[k] = 0 for the calling thread's bins
template <typename T>
__device__ void clear(const Work<T>& w, int K_place) {
  for (int k = threadIdx.x; k < K_place; k += blockDim.x) {
    w.acc[k].x = T(0);
    w.acc[k].y = T(0);
  }
}

// One row's placement into acc: ``V(f)`` returns its bin f < K_int (read by
// the first fill only); kPhase = false adds Xb without the phase ramp (the
// profiling tool's variant). All threads of the block call it; it ends with a
// __syncthreads(), after which A, B and the factors may be reused.
template <typename T, bool kPhase, typename Get>
__device__ void place_row(const Get& V, int K_int, T theta, T norm1, const fftc::Plan& p1,
                          const fftc::Plan& p2, const typename Vec2<T>::type* __restrict__ E1,
                          const typename Vec2<T>::type* __restrict__ E2, const Work<T>& w,
                          int K_place) {
  using T2 = typename Vec2<T>::type;
  const int na = (K_place + PB - 1) / PB;
  if (kPhase) {
    for (int i = threadIdx.x; i < PB + na; i += blockDim.x) {
      const T arg = i < PB ? theta * T(i) : theta * T((i - PB) * PB);
      T s, c;
      sincos_t(arg, &s, &c);
      T2 f;
      f.x = c;
      f.y = s;
      if (i < PB) w.wb[i] = f;
      else w.wa[i - PB] = f;
    }
  }
  fftc::fill(w.A, p1.L, fftc::IrfftIn<T, Get>{V, K_int, p1.n, p1.L, E1, norm1});
  T2* r1 = fftc::run<T, +1>(w.A, w.B, p1, E1);
  T2* z2 = (r1 == w.A) ? w.B : w.A;
  fftc::fill(z2, p2.L, fftc::RfftIn<T, fftc::Trace<T>>{fftc::Trace<T>{r1, p1.n % 2 == 0},
                                                       p1.n, p2.n});
  const T2* r2 = fftc::run<T, -1>(z2, r1, p2, E2);
  for (int k = threadIdx.x; k < K_place; k += blockDim.x) {
    const T2 xb = fftc::rfft_post<T>(r2, k, p2, E2);
    T2 s = w.acc[k];
    if (kPhase) {
      const T2 pa = w.wa[k / PB];
      const T2 pb = w.wb[k % PB];
      const T pr = pa.x * pb.x - pa.y * pb.y;
      const T pi = pa.x * pb.y + pa.y * pb.x;
      s.x += xb.x * pr - xb.y * pi;
      s.y += xb.x * pi + xb.y * pr;
    } else {
      s.x += xb.x;
      s.y += xb.y;
    }
    w.acc[k] = s;
  }
  __syncthreads();
}

// the accumulator of output row g to out_re / out_im [., K_place]
template <typename T>
__device__ void store(const Work<T>& w, T* __restrict__ out_re, T* __restrict__ out_im, int g,
                      int K_place) {
  for (int k = threadIdx.x; k < K_place; k += blockDim.x) {
    const size_t o = (size_t)g * K_place + k;
    out_re[o] = w.acc[k].x;
    out_im[o] = w.acc[k].y;
  }
}

}  // namespace placefft
