// Placement kernel for Hopper (sm_90a) on a materialized voltage spectrum:
// the placement onto the common time base, the sub-bin phase ramp and the
// (shower, ray) reduction, in one pass.
//
// Replaces nuradiomc_tpu/ops/placement_pallas.py::placement_reduce (kernel
// _kernel; pallas_call at placement_pallas.py:512), the placement of the
// non-factored chain (birefringence, keep_efields), and the baseline and
// matmul_only epilogues of tools/profile_placement_variants.py (kPhase = true
// / false). Contract (rows channel-major, (shower, ray) fastest, s2
// consecutive rows per output row):
//
//   Xb[r, :]  = rfft(pad(irfft(V[r, :K_int], n_int), n_base))[:K_place]
//   out[g, k] = sum_{j < s2} Xb[g*s2 + j, k] * exp(-2 pi i k df offset[g*s2 + j])
//
// K_place output columns, not the TPU kernel's 128-padded width (a lane-layout
// artifact there). The TPU kernel takes the dense placement matrices
// (pipeline._placement_matrices) of exactly this map; the placement here is
// the FFT placement of placement_fft.cuh, kernel 1's.
//
// What bounds it on the H100: bytes and operations about equally. The
// function reads every input row once (whether a row is zero is known only by
// reading it) and writes K_place complex bins per output row; on the gen2
// path (10240 rows per station, K_int 257, K_place 1025, s2 20) that is ~25
// MB in float32, 0.0075 ms at 3.35 TB/s, while the FFTs of its nonzero rows
// (2/3 of them) need ~5e8 FLOP, 0.008 ms at 67 TFLOP/s; at the profiling
// tool's shape (262144 rows, s2 4) ~1.1 GB, 0.32 ms, against ~1.3e10 FLOP.
// (The TPU kernel's dense DFT, 8 FLOP per (row, f, k), fed the MXU; on the
// CUDA cores it made the kernel compute-bound at 2 ms on the gen2 path and
// 34 ms at the tool's shape.)
//
// The design: a block (128 threads, persistent, output rows G_out/grid apart)
// owns whole output rows with all of their K_place bins. Each input row's
// K_int bins are copied into shared memory with cp.async, double-buffered so
// the next row's copy runs during this row's transforms. A row is zero where
// its solution is masked (the caller selects, pipeline.py); its placement
// adds exactly nothing, so after a block-wide OR over its bins a zero row is
// skipped. The others are placed and summed in row order (placement_fft.cuh).

#include "placement_fft.cuh"

namespace {

constexpr int NTH = 128;     // threads per block

using fftc::Vec2;

// shared-memory layout: staged rows [2][align16(2 K_int T)] | the placement's
// work memory (placement_fft.cuh)
template <typename T>
__host__ __device__ inline size_t stage_bytes(int K_int) {
  return fftc::align16(2 * (size_t)K_int * sizeof(T));
}

template <typename T>
__host__ __device__ inline placefft::Layout layout_of(int K_int, int K_place, int n_int,
                                                      int n_base) {
  return placefft::layout_of<T>(2 * stage_bytes<T>(K_int), n_int, n_base, K_place);
}

template <typename T, bool kPhase>
__global__ void __launch_bounds__(NTH) placement_reduce_kernel(
    const T* __restrict__ vre, const T* __restrict__ vim, const T* __restrict__ offsets,
    const typename Vec2<T>::type* __restrict__ E1,
    const typename Vec2<T>::type* __restrict__ E2, T* __restrict__ out_re,
    T* __restrict__ out_im, int R, int s2, int K_int, int K_place, T theta_c, T norm1,
    const __grid_constant__ fftc::Plan p1, const __grid_constant__ fftc::Plan p2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const placefft::Work<T> w(smem_raw, layout_of<T>(K_int, K_place, p1.n, p2.n));
  const size_t sst = stage_bytes<T>(K_int) / sizeof(T);   // elements per staging buffer
  T* stage = reinterpret_cast<T*>(smem_raw);
  const int G_out = R / s2;

  int g = blockIdx.x;
  if (g >= G_out) return;
  // the block's input rows in order are g * s2 + j for g = blockIdx.x,
  // + gridDim.x, ... and j < s2; row number ``it`` of the block is staged in
  // buffer it & 1
  auto fetch = [&](int row, int buf) {
    T* s = stage + buf * sst;
    fftc::row_async(s, vre + (size_t)row * K_int, K_int);
    fftc::row_async(s + K_int, vim + (size_t)row * K_int, K_int);
    fftc::cp_async_commit();
  };
  fetch(g * s2, 0);
  int it = 0;
  for (; g < G_out; g += gridDim.x) {
    placefft::clear(w, K_place);
    for (int j = 0; j < s2; ++j, ++it) {
      const int row = g * s2 + j;
      const T* s = stage + (it & 1) * sst;
      fftc::cp_async_wait_all();
      __syncthreads();                           // the row is staged; the other buffer free
      const int ng = j + 1 < s2 ? g : g + gridDim.x;
      if (ng < G_out) fetch(j + 1 < s2 ? row + 1 : ng * s2, (it + 1) & 1);
      bool nonzero = false;
      for (int f = threadIdx.x; f < 2 * K_int; f += NTH) nonzero |= s[f] != T(0);
      if (!__syncthreads_or(nonzero)) continue;  // a zero row adds nothing
      const T theta = kPhase ? theta_c * offsets[row] : T(0);
      placefft::place_row<T, kPhase>(fftc::StagedRow<T>{s, K_int}, K_int, theta, norm1, p1, p2,
                                     E1, E2, w, K_place);
    }
    placefft::store(w, out_re, out_im, g, K_place);
  }
  fftc::cp_async_wait_all();
}

template <typename T>
size_t smem_of(int K_int, int K_place, int n_int, int n_base) {
  return layout_of<T>(K_int, K_place, n_int, n_base).total;
}

// blocks of one launch: as many as fit on the card, at most one per output row
template <typename T, bool kPhase>
cudaError_t grid_of(int G_out, size_t smem, int* n_blocks) {
  return fftc::persistent_grid(placement_reduce_kernel<T, kPhase>, NTH, smem, G_out, n_blocks);
}

template <typename T, bool kPhase>
int launch(const T* vre, const T* vim, const T* offsets, const void* table_int,
           const void* table_base, T* out_re, T* out_im, int R, int s2, int K_int,
           int K_place, int n_int, int n_base, const int* radix_int, int nst_int,
           const int* radix_base, int nst_base, T theta_c, T norm1, void* stream) {
  using T2 = typename Vec2<T>::type;
  if (s2 < 1 || R < s2 || R % s2 || K_int < 1 || K_int > n_int / 2 + 1 || K_place < 1 ||
      K_place > n_base / 2 + 1 || n_int < 2 || n_int > n_base)
    return (int)cudaErrorInvalidValue;
  const fftc::Plan p1 = fftc::make_plan(n_int, radix_int, nst_int);
  const fftc::Plan p2 = fftc::make_plan(n_base, radix_base, nst_base);
  if (!fftc::plan_ok(p1) || !fftc::plan_ok(p2)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_of<T>(K_int, K_place, n_int, n_base);
  int n_blocks = 0;
  const cudaError_t err = grid_of<T, kPhase>(R / s2, smem, &n_blocks);
  if (err != cudaSuccess) return (int)err;
  placement_reduce_kernel<T, kPhase><<<n_blocks, NTH, smem, (cudaStream_t)stream>>>(
      vre, vim, offsets, static_cast<const T2*>(table_int), static_cast<const T2*>(table_base),
      out_re, out_im, R, s2, K_int, K_place, theta_c, norm1, p1, p2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_phase(const T* vre, const T* vim, const T* offsets, const void* table_int,
                 const void* table_base, T* out_re, T* out_im, int R, int s2, int K_int,
                 int K_place, int n_int, int n_base, const int* radix_int, int nst_int,
                 const int* radix_base, int nst_base, int phase, T theta_c, T norm1,
                 void* stream) {
  if (phase)
    return launch<T, true>(vre, vim, offsets, table_int, table_base, out_re, out_im, R, s2,
                           K_int, K_place, n_int, n_base, radix_int, nst_int, radix_base,
                           nst_base, theta_c, norm1, stream);
  return launch<T, false>(vre, vim, offsets, table_int, table_base, out_re, out_im, R, s2,
                          K_int, K_place, n_int, n_base, radix_int, nst_int, radix_base,
                          nst_base, theta_c, norm1, stream);
}

}  // namespace

extern "C" {

// shared memory one block needs: the wrapper refuses sizes beyond a block's
long placement_reduce_smem_bytes(int K_int, int K_place, int n_int, int n_base, int f64) {
  return (long)(f64 ? smem_of<double>(K_int, K_place, n_int, n_base)
                    : smem_of<float>(K_int, K_place, n_int, n_base));
}
// the grid a launch of these sizes uses (blocks, the phase instantiation), or -1
int placement_reduce_grid(int G_out, int K_int, int K_place, int n_int, int n_base, int f64) {
  int n = 0;
  const cudaError_t err =
      f64 ? grid_of<double, true>(G_out, smem_of<double>(K_int, K_place, n_int, n_base), &n)
          : grid_of<float, true>(G_out, smem_of<float>(K_int, K_place, n_int, n_base), &n);
  return err == cudaSuccess ? n : -1;
}

// phase != 0: the placement as contracted; phase == 0: the same without the
// phase ramp (the profiling tool's matmul_only variant)
int placement_reduce_f32(const float* vre, const float* vim, const float* offsets,
                         const void* table_int, const void* table_base, float* out_re,
                         float* out_im, int R, int s2, int K_int, int K_place, int n_int,
                         int n_base, const int* radix_int, int nst_int, const int* radix_base,
                         int nst_base, int phase, float theta_c, float norm1, void* stream) {
  return launch_phase<float>(vre, vim, offsets, table_int, table_base, out_re, out_im, R, s2,
                             K_int, K_place, n_int, n_base, radix_int, nst_int, radix_base,
                             nst_base, phase, theta_c, norm1, stream);
}

int placement_reduce_f64(const double* vre, const double* vim, const double* offsets,
                         const void* table_int, const void* table_base, double* out_re,
                         double* out_im, int R, int s2, int K_int, int K_place, int n_int,
                         int n_base, const int* radix_int, int nst_int, const int* radix_base,
                         int nst_base, int phase, double theta_c, double norm1, void* stream) {
  return launch_phase<double>(vre, vim, offsets, table_int, table_base, out_re, out_im, R, s2,
                              K_int, K_place, n_int, n_base, radix_int, nst_int, radix_base,
                              nst_base, phase, theta_c, norm1, stream);
}

}  // extern "C"
