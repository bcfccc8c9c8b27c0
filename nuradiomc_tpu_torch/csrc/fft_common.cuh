// Shared-memory FFT core of the trigger kernels (irfft_trigger.cu,
// pa_trigger.cu) and the placement kernels (placement_fft.cuh, used by
// placement_chain.cu and placement_reduce.cu).
//
// A block transforms one row at a time: all of its threads run the stages of
// a mixed-radix Stockham FFT over two ping-pong buffers in shared memory
// (radix 16, 4, 2, 3 and 5 butterflies, and a generic one for any other
// prime; the radix-16 one runs in registers as 4 x 4, so a 1024-point
// transform takes three passes through shared memory instead of five),
// one __syncthreads() per stage. Stage st with radix R, after stages whose
// radices multiply to Ns, computes for each j < L/R (k = j % Ns):
//
//   v[r]  = src[j + r L/R] * w^(r k),        w = exp(+-2 pi i / (Ns R))
//   V[q]  = sum_r v[r] exp(+-2 pi i r q / R)
//   dst[(j / Ns) Ns R + k + q Ns] = V[q]
//
// (the self-sorting form: the result is in natural order). The sign is + for
// the inverse transform, - for the forward one; neither normalises.
//
// Real transforms of length n use the half-length complex transform when n
// is even (L = n/2, Hermitian pre- or post-step) and the full-length one when
// n is odd (L = n). Twiddles are never computed on the card: every factor
// comes from one table E[k] = exp(+2 pi i k / n), k < n, computed on the host
// in float64 and cast to the working type (ops/fft_plan.py), read through the
// read-only cache; the radix-3 and radix-5 butterflies use their constants as
// float64 literals. The stage list (the radices of L, in order) comes from
// the host too (fft_plan.radices), so a pure-torch mirror of this
// decomposition in the tests follows the same index arithmetic.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fftc {

constexpr int MAX_STAGES = 24;

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

// one real length n: its complex length L and stage radices
struct Plan {
  int n;        // real length
  int L;        // complex length: n / 2 (n even) or n (n odd)
  int tws;      // n / L: table stride of the complex transform's twiddles
  int nst;      // number of stages
  int radix[MAX_STAGES];
};

// the complex length a real transform of length n runs at
__host__ __device__ inline int complex_length(int n) { return (n % 2 == 0) ? n / 2 : n; }

inline Plan make_plan(int n, const int* radix, int nst) {
  Plan p;
  p.n = n;
  p.L = complex_length(n);
  p.tws = n / p.L;
  p.nst = nst;
  for (int i = 0; i < MAX_STAGES; ++i) p.radix[i] = i < nst ? radix[i] : 1;
  return p;
}

// host check that the stage radices multiply to L
inline bool plan_ok(const Plan& p) {
  if (p.nst < 0 || p.nst > MAX_STAGES || p.n < 1) return false;
  long prod = 1;
  for (int i = 0; i < p.nst; ++i) {
    if (p.radix[i] < 2) return false;
    prod *= p.radix[i];
  }
  return prod == p.L;
}

template <typename T2>
__device__ __forceinline__ T2 cadd(T2 a, T2 b) { a.x += b.x; a.y += b.y; return a; }
template <typename T2>
__device__ __forceinline__ T2 csub(T2 a, T2 b) { a.x -= b.x; a.y -= b.y; return a; }
template <typename T2>
__device__ __forceinline__ T2 cmul(T2 a, T2 b) {
  T2 c;
  c.x = a.x * b.x - a.y * b.y;
  c.y = a.x * b.y + a.y * b.x;
  return c;
}
template <typename T2>
__device__ __forceinline__ T2 cconj(T2 a) { a.y = -a.y; return a; }
// i * a (kSign = +1) or -i * a (kSign = -1)
template <int kSign, typename T2>
__device__ __forceinline__ T2 cmuli(T2 a) {
  T2 c;
  c.x = kSign > 0 ? -a.y : a.y;
  c.y = kSign > 0 ? a.x : -a.x;
  return c;
}

// in-place 4-point DFT, sign kSign: (a, b, c, d) -> sum_r x_r (kSign i)^(r q)
template <int kSign, typename T2>
__device__ __forceinline__ void dft4(T2& a, T2& b, T2& c, T2& d) {
  const T2 a0 = cadd(a, c), a1 = csub(a, c);
  const T2 a2 = cadd(b, d), a3 = cmuli<kSign>(csub(b, d));
  a = cadd(a0, a2);
  b = cadd(a1, a3);
  c = csub(a0, a2);
  d = csub(a1, a3);
}

// exp(kSign 2 pi i m / 16) for m = r0 q0 <= 9, from float64 literals
template <int kSign, typename T>
__device__ __forceinline__ typename Vec2<T>::type w16(int m) {
  constexpr double C1 = 0.92387953251128675613;   // cos(pi / 8)
  constexpr double S1 = 0.38268343236508977173;   // sin(pi / 8)
  constexpr double H = 0.70710678118654752440;    // cos(pi / 4)
  typename Vec2<T>::type w;
  switch (m) {
    case 1: w.x = T(C1); w.y = T(S1); break;
    case 2: w.x = T(H); w.y = T(H); break;
    case 3: w.x = T(S1); w.y = T(C1); break;
    case 4: w.x = T(0); w.y = T(1); break;
    case 6: w.x = T(-H); w.y = T(H); break;
    default: w.x = T(-C1); w.y = T(-S1); break;   // m = 9
  }
  if (kSign < 0) w.y = -w.y;
  return w;
}

// E[idx] for the inverse (kSign +1) or its conjugate for the forward (-1)
template <int kSign, typename T2>
__device__ __forceinline__ T2 tw(const T2* __restrict__ E, int idx) {
  T2 w = __ldg(E + idx);
  if (kSign < 0) w.y = -w.y;
  return w;
}

// ``buf[i] = load(i)`` for i < n by the whole block, then __syncthreads()
template <typename T2, typename Load>
__device__ void fill(T2* buf, int n, const Load& load) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = load(i);
  __syncthreads();
}

// the stages of one transform, from ``a`` (holding the input) with ``b`` as
// the other buffer; returns the buffer that holds the result: ``a`` when the
// number of stages is even, else ``b``. All threads of the block call it; it
// ends with a __syncthreads().
template <typename T, int kSign>
__device__ typename Vec2<T>::type* run(typename Vec2<T>::type* a,
                                       typename Vec2<T>::type* b, const Plan& p,
                                       const typename Vec2<T>::type* __restrict__ E) {
  using T2 = typename Vec2<T>::type;
  T2* src = a;
  T2* dst = b;
  const int L = p.L;
  int Ns = 1;
  int lg = 0;          // log2(Ns) while every radix so far is a power of two
  bool pow2 = true;
  for (int st = 0; st < p.nst; ++st) {
    const int R = p.radix[st];
    const int nb = L / R;
    const int step = (L / (Ns * R)) * p.tws;   // table index of w^1
    for (int j = threadIdx.x; j < nb; j += blockDim.x) {
      const int k = pow2 ? (j & (Ns - 1)) : j % Ns;
      const int d0 = (pow2 ? (j >> lg) : j / Ns) * Ns * R + k;
      if (R == 4) {
        T2 v0 = src[j];
        T2 v1 = cmul(src[j + nb], tw<kSign>(E, k * step));
        T2 v2 = cmul(src[j + 2 * nb], tw<kSign>(E, 2 * k * step));
        T2 v3 = cmul(src[j + 3 * nb], tw<kSign>(E, 3 * k * step));
        const T2 a0 = cadd(v0, v2), a1 = csub(v0, v2);
        const T2 a2 = cadd(v1, v3), a3 = cmuli<kSign>(csub(v1, v3));
        dst[d0] = cadd(a0, a2);
        dst[d0 + Ns] = cadd(a1, a3);
        dst[d0 + 2 * Ns] = csub(a0, a2);
        dst[d0 + 3 * Ns] = csub(a1, a3);
      } else if (R == 16) {
        // 16 = 4 x 4: 4-point DFTs over r1 (r = 4 r1 + r0), the internal
        // twiddles w16^(r0 q0), 4-point DFTs over r0 (q = q0 + 4 q1)
        T2 v[16];
#pragma unroll
        for (int r = 0; r < 16; ++r)
          v[r] = r == 0 ? src[j] : cmul(src[j + r * nb], tw<kSign>(E, r * k * step));
#pragma unroll
        for (int r0 = 0; r0 < 4; ++r0) dft4<kSign>(v[r0], v[r0 + 4], v[r0 + 8], v[r0 + 12]);
        // v[r0 + 4 q0] now holds U[r0][q0]
#pragma unroll
        for (int r0 = 1; r0 < 4; ++r0)
#pragma unroll
          for (int q0 = 1; q0 < 4; ++q0) v[r0 + 4 * q0] = cmul(v[r0 + 4 * q0], w16<kSign, T>(r0 * q0));
#pragma unroll
        for (int q0 = 0; q0 < 4; ++q0) {
          T2 u0 = v[4 * q0], u1 = v[4 * q0 + 1], u2 = v[4 * q0 + 2], u3 = v[4 * q0 + 3];
          dft4<kSign>(u0, u1, u2, u3);
          dst[d0 + q0 * Ns] = u0;
          dst[d0 + (q0 + 4) * Ns] = u1;
          dst[d0 + (q0 + 8) * Ns] = u2;
          dst[d0 + (q0 + 12) * Ns] = u3;
        }
      } else if (R == 2) {
        const T2 v0 = src[j];
        const T2 v1 = cmul(src[j + nb], tw<kSign>(E, k * step));
        dst[d0] = cadd(v0, v1);
        dst[d0 + Ns] = csub(v0, v1);
      } else if (R == 3) {
        const T c = T(-0.5);
        const T s = T(kSign) * T(0.86602540378443864676);   // sin(2 pi / 3)
        const T2 v0 = src[j];
        const T2 v1 = cmul(src[j + nb], tw<kSign>(E, k * step));
        const T2 v2 = cmul(src[j + 2 * nb], tw<kSign>(E, 2 * k * step));
        const T2 t1 = cadd(v1, v2), t2 = csub(v1, v2);
        T2 m;
        m.x = v0.x + c * t1.x;
        m.y = v0.y + c * t1.y;
        T2 st2;                                     // i s t2
        st2.x = -s * t2.y;
        st2.y = s * t2.x;
        dst[d0] = cadd(v0, t1);
        dst[d0 + Ns] = cadd(m, st2);
        dst[d0 + 2 * Ns] = csub(m, st2);
      } else if (R == 5) {
        const T c1 = T(0.30901699437494742410);    // cos(2 pi / 5)
        const T c2 = T(-0.80901699437494742410);   // cos(4 pi / 5)
        const T s1 = T(kSign) * T(0.95105651629515357212);   // sin(2 pi / 5)
        const T s2 = T(kSign) * T(0.58778525229247312917);   // sin(4 pi / 5)
        const T2 v0 = src[j];
        const T2 v1 = cmul(src[j + nb], tw<kSign>(E, k * step));
        const T2 v2 = cmul(src[j + 2 * nb], tw<kSign>(E, 2 * k * step));
        const T2 v3 = cmul(src[j + 3 * nb], tw<kSign>(E, 3 * k * step));
        const T2 v4 = cmul(src[j + 4 * nb], tw<kSign>(E, 4 * k * step));
        const T2 t1 = cadd(v1, v4), t2 = cadd(v2, v3);
        const T2 t3 = csub(v1, v4), t4 = csub(v2, v3);
        T2 m1, m2, q1, q2;
        m1.x = v0.x + c1 * t1.x + c2 * t2.x;
        m1.y = v0.y + c1 * t1.y + c2 * t2.y;
        m2.x = v0.x + c2 * t1.x + c1 * t2.x;
        m2.y = v0.y + c2 * t1.y + c1 * t2.y;
        q1.x = -(s1 * t3.y + s2 * t4.y);            // i (s1 t3 + s2 t4)
        q1.y = s1 * t3.x + s2 * t4.x;
        q2.x = -(s2 * t3.y - s1 * t4.y);            // i (s2 t3 - s1 t4)
        q2.y = s2 * t3.x - s1 * t4.x;
        dst[d0] = cadd(v0, cadd(t1, t2));
        dst[d0 + Ns] = cadd(m1, q1);
        dst[d0 + 2 * Ns] = cadd(m2, q2);
        dst[d0 + 3 * Ns] = csub(m2, q2);
        dst[d0 + 4 * Ns] = csub(m1, q1);
      } else {
        // any other prime: the R-point DFT from the table, O(R^2)
        const int rq_step = (L / R) * p.tws;       // table index of exp(2 pi i / R)
        for (int q = 0; q < R; ++q) {
          T2 acc;
          acc.x = T(0);
          acc.y = T(0);
          for (int r = 0; r < R; ++r) {
            const T2 v = cmul(src[j + r * nb], tw<kSign>(E, r * k * step));
            acc = cadd(acc, cmul(v, tw<kSign>(E, ((r * q) % R) * rq_step)));
          }
          dst[d0 + q * Ns] = acc;
        }
      }
    }
    __syncthreads();
    T2* t = src;
    src = dst;
    dst = t;
    Ns *= R;
    if (pow2 && (R & (R - 1)) == 0) lg += __ffs(R) - 1;
    else pow2 = false;
  }
  return src;
}

// Inverse real transform, the pre-step (written out by fill): element k < L
// of the complex input of the inverse transform from the one-sided spectrum
// X[0..K) (zero from K on), times ``norm``. Im of the DC bin, and of the Nyquist bin when n is
// even, is dropped, as numpy's irfft does. ``get(k)`` returns X[k], k < K.
//   n even: Z[k] = (X[k] + conj X[L-k]) + i E[k] (X[k] - conj X[L-k])
//   n odd:  Z[k] = X[k] (k <= (n-1)/2), conj X[n-k] (k > (n-1)/2)
template <typename T, typename Get>
struct IrfftIn {
  Get get;
  int K, n, L;
  const typename Vec2<T>::type* E;
  T norm;
  __device__ typename Vec2<T>::type operator()(int k) const {
    using T2 = typename Vec2<T>::type;
    T2 z;
    if (n % 2 == 0) {
      T2 x, y;
      x.x = x.y = y.x = y.y = T(0);
      if (k < K) x = get(k);
      if (k == 0) x.y = T(0);
      const int k2 = L - k;                        // 1 .. L; L is the Nyquist bin
      if (k2 < K) y = get(k2);
      if (k2 == L) y.y = T(0);
      const T2 a = cadd(x, cconj(y));
      const T2 b = cmul(csub(x, cconj(y)), __ldg(E + k));
      z.x = a.x - b.y;
      z.y = a.y + b.x;
    } else {
      z.x = z.y = T(0);
      const int h = (n - 1) / 2;
      if (k <= h) {
        if (k < K) z = get(k);
        if (k == 0) z.y = T(0);
      } else if (n - k < K) {
        z = cconj(get(n - k));
      }
    }
    z.x *= norm;
    z.y *= norm;
    return z;
  }
};

// Forward real transform, the pre-step (written out by fill): element m < L
// of the complex input of the forward transform from the real samples x(t),
// t < n_in (zero beyond, n_in <= n): n even: x(2m) + i x(2m+1); n odd: x(m)
template <typename T, typename Get>
struct RfftIn {
  Get x;
  int n_in, n;
  __device__ typename Vec2<T>::type operator()(int m) const {
    typename Vec2<T>::type v;
    if (n % 2 == 0) {
      v.x = 2 * m < n_in ? x(2 * m) : T(0);
      v.y = 2 * m + 1 < n_in ? x(2 * m + 1) : T(0);
    } else {
      v.x = m < n_in ? x(m) : T(0);
      v.y = T(0);
    }
    return v;
  }
};

// Forward real transform, the post-step: bin k (0 <= k <= n/2) of the rfft from the
// forward transform's result Z:
//   n even: Xb[k] = (Z[k] + conj Z[L-k]) / 2 - i conj(E[k]) (Z[k] - conj Z[L-k]) / 2
//           (Z[L] = Z[0]);  n odd: Xb[k] = Z[k]
template <typename T>
__device__ __forceinline__ typename Vec2<T>::type rfft_post(
    const typename Vec2<T>::type* Z, int k, const Plan& p,
    const typename Vec2<T>::type* __restrict__ E) {
  using T2 = typename Vec2<T>::type;
  if (p.n % 2) return Z[k];
  const int L = p.L;
  const T2 a = Z[k == L ? 0 : k];
  const T2 b = cconj(Z[k == 0 ? 0 : L - k]);
  const T2 s = cadd(a, b);
  const T2 d = csub(a, b);
  T2 fo;                                          // -i d / 2
  fo.x = d.y * T(0.5);
  fo.y = -d.x * T(0.5);
  T2 fe;
  fe.x = s.x * T(0.5);
  fe.y = s.y * T(0.5);
  return cadd(fe, cmul(fo, cconj(__ldg(E + k))));
}

// ---- getters of the loaders ----------------------------------------------

template <typename T>
struct StagedRow {   // X[k] from a staging buffer: re [0, K), im [K, 2K)
  const T* s;
  int K;
  __device__ typename Vec2<T>::type operator()(int k) const {
    typename Vec2<T>::type v;
    v.x = s[k];
    v.y = s[K + k];
    return v;
  }
};

template <typename T>
struct Trace {       // the real samples x(t) of an inverse real transform's result r
  const typename Vec2<T>::type* r;
  bool packed;       // n even: r holds x(2m) + i x(2m+1); n odd: x(t) = Re r[t]
  __device__ T operator()(int t) const {
    return packed ? reinterpret_cast<const T*>(r)[t] : r[t].x;
  }
};

// The decimated inverse real transform as a folded spectrum: when decim n_dec
// = n_hi,
//   irfft(X, n_hi)[::decim] = (1/n_hi) IDFT_{n_dec}(Z),
//   Z_r = sum_{k = r (mod n_dec)} Y_k,
// Y the Hermitian extension of X (zero from Kh on) to n_hi bins, with numpy's
// edge rules before folding (Im dropped at DC and at n_hi's Nyquist). Z is
// Hermitian too, so IrfftIn<T, FoldIn> of length n_dec over Z_0..Z_{n_dec/2}
// (norm 1/n_hi) gives the decimated trace. ``x(k)`` returns X[k], k < Kh.
template <typename T, typename Get>
struct FoldIn {
  Get x;
  int Kh, n_hi, n_dec;
  __device__ typename Vec2<T>::type operator()(int r) const {
    typename Vec2<T>::type z;
    z.x = z.y = T(0);
    for (int k = r; k < Kh; k += n_dec) {          // Y_k = X_k
      typename Vec2<T>::type v = x(k);
      if (k == 0 || 2 * k == n_hi) v.y = T(0);
      z = cadd(z, v);
    }
    // Y_{n_hi - j} = conj X_j for 0 < j < Kh, j = -r (mod n_dec), j != n_hi / 2
    for (int j = r == 0 ? n_dec : n_dec - r; j < Kh; j += n_dec) {
      if (2 * j == n_hi) continue;
      z = cadd(z, cconj(x(j)));
    }
    return z;
  }
};

// bin k (k <= n/2) of the rfft whose forward transform is in Z (rfft_post),
// Im dropped at DC and Nyquist, where the rfft of real samples is real
template <typename T>
struct RfftOut {
  const typename Vec2<T>::type* Z;
  const Plan* p;
  const typename Vec2<T>::type* E;
  __device__ typename Vec2<T>::type operator()(int k) const {
    typename Vec2<T>::type v = rfft_post<T>(Z, k, *p, E);
    if (k == 0 || 2 * k == p->n) v.y = T(0);
    return v;
  }
};

// ---- block-wide reductions (NWARP warps) -----------------------------------

template <int NWARP>
__device__ int block_min(int x, int* warp_buf) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  x = __reduce_min_sync(0xffffffffu, x);
  if (lane == 0) warp_buf[wid] = x;
  __syncthreads();
  int m = warp_buf[0];
#pragma unroll
  for (int w = 1; w < NWARP; ++w) m = min(m, warp_buf[w]);
  __syncthreads();
  return m;
}

template <typename T>
__device__ __forceinline__ T warp_max(T x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_down_sync(0xffffffffu, x, o));
  return x;
}

// ---- asynchronous copies of one row into shared memory --------------------

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_8(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// copy count elements of T from global to shared memory without waiting:
// 16-byte copies when both addresses allow it, else one element at a time
template <typename T>
__device__ void row_async(T* smem, const T* gmem, int count) {
  const bool vec = ((reinterpret_cast<uintptr_t>(gmem) | reinterpret_cast<uintptr_t>(smem)) & 15) == 0;
  constexpr int PER = 16 / sizeof(T);
  int done = 0;
  if (vec) {
    const int nv = count / PER;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) cp_async_16(smem + i * PER, gmem + i * PER);
    done = nv * PER;
  }
  for (int i = done + threadIdx.x; i < count; i += blockDim.x) {
    if (sizeof(T) == 4) cp_async_4(smem + i, gmem + i);
    else cp_async_8(smem + i, gmem + i);
  }
}

// device properties a launcher sizes its grid by
inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// blocks of a persistent launch: as many as fit on the card (after the
// kernel's dynamic shared memory is allowed), at most ``work`` (one per group
// or output row)
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem, int work, int* n_blocks) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long cap = (long)per_sm * sm_count();
  *n_blocks = (int)(work < cap ? work : cap);
  return cudaSuccess;
}

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

}  // namespace fftc
