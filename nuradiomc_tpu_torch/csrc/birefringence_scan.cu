// The birefringent segment scan for Hopper (sm_90a): every path's (eTheta,
// ePhi) spectrum carried through all of its segments' eigenbasis rotations
// and relative time shifts in one launch.
//
// Replaces no pallas_call: the JAX package runs this scan as a lax.scan over
// the segments inside propagate_pulse (nuradiomc_tpu/ops/birefringence.py:191),
// vmapped over the paths, and the port's plain version
// (ops/birefringence.segment_scan_plain) as a Python loop of ~24 elementwise
// launches a segment over [P, F] complex tensors, which stays its CPU path.
// That loop reads and writes every spectrum element through device memory
// some 24 times a segment; here each element is read once, carried through
// all segments in registers and written once.
//
// Contract (P paths, S segments a path, F frequencies; every array
// contiguous, T float or double):
//
//   cpsi, spsi   [P, S] T      the fast mode's eigenvector angle (cos, sin)
//   k1sq, k2sq   [P, S] T      the modes' walk-off damping
//   dt_rel       [P, S] T      the slow mode's delay (t_slow - t_fast)
//   ok           [P, S] uint8  0 where the segment is skipped
//   spec_theta,
//   spec_phi     [P, F] complex T, interleaved (re, im)
//   freqs        [F] T
//   out_theta,
//   out_phi      [P, F] complex T, the propagated spectra
//
// A segment with ok set maps (st, sp) as the plain version does, operation
// for operation and in its order:
//
//   arg = ((-2 pi) * dt) * f;   ph = cos(arg) + i sin(arg)
//   b0  = k1sq * (c * st + s * sp)            (fast mode)
//   b1  = (k2sq * ((-s) * st + c * sp)) * ph  (slow mode; c10's complex product)
//   st' = c * b0 - s * b1;      sp' = s * b0 + c * b1
//
// with -2 pi a double rounded to T. A real factor multiplies the real and the
// imaginary part alone (ATen multiplies a real tensor as the complex c + 0i,
// which gives the same value, up to the sign of a zero), and a complex sum is
// the sums of the parts. The build compiles this file with -fmad=false
// (ops/_build.py), so every product and sum rounds on its own as in ATen's
// elementwise kernels, but for the one complex product: ATen's CUDA build
// contracts c10's (a + bi)(c + di) = (ac - bd) + (ad + bc)i into
// fma(a, c, -(b d)) and fma(a, d, b c) (both dtypes, every sampled product on
// the H100), and the kernel writes those two fused multiply-adds as they are.
// So it gives the plain loop's bits on the card. A segment with ok clear
// leaves (st, sp) as they are: a branch, never a multiply, so its non-finite
// parameters are never read into the spectrum.
//
// What bounds it on the H100: arithmetic. A segment costs an element one
// sine and one cosine and 35 real operations (the product w * f, the two
// mode projections with their damping, the complex phase product and the
// rotation back), while the element's 4 T are read and written once. At the
// gen2 cell's shapes (P ~12k valid paths a station and chunk, S 255, F 513)
// that is ~1.6e9 segment updates a launch against ~0.4 GB of spectra. The
// bound the benchmark counts (chip_smoke._birefringence_scan_ops) is the
// output elements of the plain version's ATen ops, a transcendental counting
// one, at 67 TFLOP/s: far above the bytes at 3.35 TB/s.
//
// The design: one block of 128 threads a path. The block copies its path's S
// segments into shared memory once (c, s, k1sq, k2sq, w = (-2 pi) dt and ok,
// six T a segment: 12 KB at S 255 in double), then each thread takes the
// frequencies tid, tid + 128, ... and carries each element's (st, sp) in
// registers through all S segments. Every thread of a block reads the same
// segment at the same time, so the shared reads broadcast and the ok branch
// never diverges. ~12k blocks a launch fill the 132 SMs many times over.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NTH = 128;      // threads per block (one block a path)
constexpr int REC = 6;        // T a segment in shared memory: c, s, k1, k2, w, ok

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

// the library's cosine, sine and fused multiply-add of the dtype, as ATen's
// cos and sin call them and its build contracts a complex product
__device__ __forceinline__ float cos_of(float x) { return cosf(x); }
__device__ __forceinline__ double cos_of(double x) { return ::cos(x); }
__device__ __forceinline__ float sin_of(float x) { return sinf(x); }
__device__ __forceinline__ double sin_of(double x) { return ::sin(x); }
__device__ __forceinline__ float fma_of(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_of(double a, double b, double c) { return ::fma(a, b, c); }

template <typename T>
__global__ void __launch_bounds__(NTH)
birefringence_scan_kernel(const T* __restrict__ cpsi, const T* __restrict__ spsi,
                          const T* __restrict__ k1sq, const T* __restrict__ k2sq,
                          const T* __restrict__ dt_rel, const unsigned char* __restrict__ ok,
                          const T* __restrict__ spec_theta, const T* __restrict__ spec_phi,
                          const T* __restrict__ freqs, int n_seg, int n_freq, T m2pi,
                          T* __restrict__ out_theta, T* __restrict__ out_phi) {
  using V = typename Vec2<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* seg = reinterpret_cast<T*>(smem_raw);
  const long path = blockIdx.x;
  const long base = path * n_seg;
  for (int k = threadIdx.x; k < n_seg; k += NTH) {
    T* r = seg + REC * k;
    r[0] = cpsi[base + k];
    r[1] = spsi[base + k];
    r[2] = k1sq[base + k];
    r[3] = k2sq[base + k];
    r[4] = m2pi * dt_rel[base + k];
    r[5] = ok[base + k] ? T(1) : T(0);
  }
  __syncthreads();

  const V* in_t = reinterpret_cast<const V*>(spec_theta) + path * n_freq;
  const V* in_p = reinterpret_cast<const V*>(spec_phi) + path * n_freq;
  V* o_t = reinterpret_cast<V*>(out_theta) + path * n_freq;
  V* o_p = reinterpret_cast<V*>(out_phi) + path * n_freq;
  for (int j = threadIdx.x; j < n_freq; j += NTH) {
    const T f = freqs[j];
    const V t0 = in_t[j], p0 = in_p[j];
    T st_r = t0.x, st_i = t0.y, sp_r = p0.x, sp_i = p0.y;
    for (int k = 0; k < n_seg; ++k) {
      const T* r = seg + REC * k;
      if (r[5] == T(0)) continue;
      const T c = r[0], s = r[1], k1 = r[2], k2 = r[3];
      const T arg = r[4] * f;
      const T pc = cos_of(arg), ps = sin_of(arg);
      // fast mode: k1 (c st + s sp)
      const T b0_r = k1 * (c * st_r + s * sp_r);
      const T b0_i = k1 * (c * st_i + s * sp_i);
      // slow mode: k2 (-s st + c sp), then times the phase
      const T d_r = k2 * ((-s) * st_r + c * sp_r);
      const T d_i = k2 * ((-s) * st_i + c * sp_i);
      const T b1_r = fma_of(d_r, pc, -(d_i * ps));
      const T b1_i = fma_of(d_r, ps, d_i * pc);
      st_r = c * b0_r - s * b1_r;
      st_i = c * b0_i - s * b1_i;
      sp_r = s * b0_r + c * b1_r;
      sp_i = s * b0_i + c * b1_i;
    }
    V a, b;
    a.x = st_r;
    a.y = st_i;
    b.x = sp_r;
    b.y = sp_i;
    o_t[j] = a;
    o_p[j] = b;
  }
}

constexpr long SMEM_MAX = 232448;   // the most dynamic shared memory a block may take

template <typename T>
long smem_bytes(int n_seg) { return (long)REC * sizeof(T) * n_seg; }

template <typename T>
int launch(const T* cpsi, const T* spsi, const T* k1sq, const T* k2sq, const T* dt_rel,
           const unsigned char* ok, const T* spec_theta, const T* spec_phi, const T* freqs,
           long n_paths, int n_seg, int n_freq, double m2pi, T* out_theta, T* out_phi,
           void* stream) {
  if (n_paths < 0 || n_paths > 0x7fffffffL || n_seg < 0 || n_freq < 0 ||
      smem_bytes<T>(n_seg) > SMEM_MAX)
    return cudaErrorInvalidValue;
  if (n_paths == 0 || n_freq == 0) return cudaSuccess;
  const long smem = smem_bytes<T>(n_seg);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(birefringence_scan_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  birefringence_scan_kernel<T><<<(unsigned)n_paths, NTH, (size_t)smem, (cudaStream_t)stream>>>(
      cpsi, spsi, k1sq, k2sq, dt_rel, ok, spec_theta, spec_phi, freqs, n_seg, n_freq, (T)m2pi,
      out_theta, out_phi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The most segments a path may have: its records must fit one block's
// shared memory.
int birefringence_scan_max_segments(int f64) {
  return (int)(SMEM_MAX / (REC * (f64 ? sizeof(double) : sizeof(float))));
}

// Every pointer is device memory (spec_* and out_* interleaved complex);
// m2pi is -2 pi, rounded to the dtype inside. Returns the launch's
// cudaError_t (cudaErrorInvalidValue for arguments outside the contract).
int birefringence_scan_f32(const float* cpsi, const float* spsi, const float* k1sq,
                           const float* k2sq, const float* dt_rel, const unsigned char* ok,
                           const float* spec_theta, const float* spec_phi, const float* freqs,
                           long n_paths, int n_seg, int n_freq, double m2pi, float* out_theta,
                           float* out_phi, void* stream) {
  return launch<float>(cpsi, spsi, k1sq, k2sq, dt_rel, ok, spec_theta, spec_phi, freqs, n_paths,
                       n_seg, n_freq, m2pi, out_theta, out_phi, stream);
}

int birefringence_scan_f64(const double* cpsi, const double* spsi, const double* k1sq,
                           const double* k2sq, const double* dt_rel, const unsigned char* ok,
                           const double* spec_theta, const double* spec_phi, const double* freqs,
                           long n_paths, int n_seg, int n_freq, double m2pi, double* out_theta,
                           double* out_phi, void* stream) {
  return launch<double>(cpsi, spsi, k1sq, k2sq, dt_rel, ok, spec_theta, spec_phi, freqs, n_paths,
                        n_seg, n_freq, m2pi, out_theta, out_phi, stream);
}

}  // extern "C"
