// Placement chain kernel for Hopper (sm_90a): the factored propagation chain,
// the placement onto the common time base, the sub-bin phase ramp and the
// (shower, ray) reduction, in one pass.
//
// Replaces nuradiomc_tpu/ops/placement_pallas.py::chain_placement_reduce_v3
// (kernel _chain_kernel_v3; pallas_call at placement_pallas.py:452) and, with
// the same contract, the v2 chain_placement_reduce (pallas_call at :209).
// Contract (rows channel-major, (shower, ray) fastest, s2 consecutive rows
// per output row):
//
//   att[r, f]  = sum_s att_sparse[r, s] * W[s, f]
//   V[r, f]    = mask[r] ? tpl[tpl_idx[r], f] * comb[r] * spec[r, f] * att[r, f] : 0
//   Xb[r, :]   = rfft(pad(irfft(V[r, :K_int], n_int), n_base))[:K_place]
//   out[g, k]  = sum_{j < s2} Xb[g*s2 + j, k] * exp(-2 pi i k df offset[g*s2 + j])
//
// The mask is a select, not a multiply: a masked row may carry NaN spectra; it
// adds nothing, so the kernel skips its work. The placement (numpy's irfft and
// rfft, the factored phase ramp) is placement_fft.cuh's, shared with kernel 4.
//
// What bounds it on the H100: bytes and operations about equally. The
// function reads each unmasked input row's spectra, attenuation nodes and
// scalars once and writes K_place complex bins per output row; at the
// headline shape (262144 rows, 2/3 unmasked, K_int 208, 24 sparse
// frequencies, K_place 816, s2 4) that is ~740 MB in float32 (~1480 MB in
// float64), 0.221 ms (0.442 ms) at 3.35 TB/s. Its transforms (an inverse
// real FFT of n_int and a forward one of n_base pruned to its n_int nonzero
// inputs) and the chain need ~1.5e10 FLOP, 0.226 ms at 67 TFLOP/s.
// (The TPU kernel's dense placement DFT, 3.6e11 FLOP, fed the MXU; on the
// CUDA cores it made the kernel compute-bound at 21-30 ms.)
//
// The design: a block (128 threads) owns whole output rows (persistent
// blocks, G_out/grid apart) with all of their K_place bins, so the chain
// stage runs once per input row. Each unmasked input row is built into
// shared memory (V) and placed by the FFT placement of placement_fft.cuh
// (irfft of n_int, rfft of the zero-padded trace of n_base, phase ramp, sum
// into the output row's accumulator in row order). The next unmasked row's
// spectra and attenuation nodes are copied in with cp.async while the current
// row is transformed. The time grows with the unmasked rows only.

#include "placement_fft.cuh"

namespace {

constexpr int NTH = 128;     // threads per block
using fftc::Vec2;

template <typename T>
struct ChainArgs {
  const T *spec_re, *spec_im, *att_sparse, *comb_re, *comb_im;
  const uint8_t* mask;
  const int32_t* tpl_idx;
  const T *offsets, *W, *tpl_re, *tpl_im;
};

// shared-memory layout, each part 16-byte aligned:
//   staged row [2 K_int + n_sparse] T | V [K_int] T2 | the placement's work
//   memory (placement_fft.cuh)
struct Layout {
  size_t stg, V;
  placefft::Layout work;
};

template <typename T>
__host__ __device__ inline Layout layout_of(int K_int, int n_sparse, int K_place, int n_int,
                                            int n_base) {
  using T2 = typename Vec2<T>::type;
  Layout l;
  l.stg = 0;
  l.V = fftc::align16((2 * (size_t)K_int + n_sparse) * sizeof(T));
  l.work = placefft::layout_of<T>(l.V + fftc::align16((size_t)K_int * sizeof(T2)), n_int,
                                  n_base, K_place);
  return l;
}

template <typename T>
struct Spectrum {   // V[f] from shared memory
  const typename Vec2<T>::type* V;
  __device__ typename Vec2<T>::type operator()(int f) const { return V[f]; }
};

template <typename T>
__global__ void __launch_bounds__(NTH) placement_chain_kernel(
    ChainArgs<T> a, const typename Vec2<T>::type* __restrict__ E1,
    const typename Vec2<T>::type* __restrict__ E2, T* __restrict__ out_re,
    T* __restrict__ out_im, int R, int s2, int K_int, int n_sparse, int K_place,
    T theta_c, T norm1, const __grid_constant__ fftc::Plan p1,
    const __grid_constant__ fftc::Plan p2) {
  using T2 = typename Vec2<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout lay = layout_of<T>(K_int, n_sparse, K_place, p1.n, p2.n);
  T* stg = reinterpret_cast<T*>(smem_raw + lay.stg);
  T2* V = reinterpret_cast<T2*>(smem_raw + lay.V);
  const placefft::Work<T> w(smem_raw, lay.work);
  const int tid = threadIdx.x;
  const int G_out = R / s2;

  // The block's input rows in order are g * s2 + j for g = blockIdx.x,
  // + gridDim.x, ... and j < s2. The next unmasked one's spectra and
  // attenuation nodes are copied into ``stg`` (cp.async) while the current
  // one is transformed, its scalars loaded into registers.
  auto live_from = [&](int g, int j) {           // first unmasked row at (g, j) or
    for (; g < G_out; g += gridDim.x, j = 0)     // later; -1 when none is left
      for (; j < s2; ++j)
        if (a.mask[g * s2 + j]) return g * s2 + j;
    return -1;
  };
  T cr = T(0), ci = T(0), off = T(0);
  int tpl = 0;
  auto fetch = [&](int row) {
    fftc::row_async(stg, a.spec_re + (size_t)row * K_int, K_int);
    fftc::row_async(stg + K_int, a.spec_im + (size_t)row * K_int, K_int);
    fftc::row_async(stg + 2 * K_int, a.att_sparse + (size_t)row * n_sparse, n_sparse);
    fftc::cp_async_commit();
    cr = a.comb_re[row];
    ci = a.comb_im[row];
    off = a.offsets[row];
    tpl = a.tpl_idx[row];
  };
  const int first = live_from(blockIdx.x, 0);
  if (first >= 0) fetch(first);

  for (int g = blockIdx.x; g < G_out; g += gridDim.x) {
    placefft::clear(w, K_place);
    for (int j = 0; j < s2; ++j) {
      const int row = g * s2 + j;
      if (!a.mask[row]) continue;                // the same for the whole block

      // ---- the factored chain into V ----------------------------------------
      fftc::cp_async_wait_all();
      __syncthreads();                           // the row is staged
      const T* as = stg + 2 * K_int;
      const size_t tpl0 = (size_t)tpl * K_int;
      for (int f = tid; f < K_int; f += NTH) {
        T att = T(0);
#pragma unroll 8
        for (int s = 0; s < n_sparse; ++s) att += as[s] * __ldg(a.W + (size_t)s * K_int + f);
        const T sr = stg[f] * att;
        const T si = stg[K_int + f] * att;
        const T csr = cr * sr - ci * si;
        const T csi = cr * si + ci * sr;
        const T tr = a.tpl_re[tpl0 + f];
        const T ti = a.tpl_im[tpl0 + f];
        T2 v;
        v.x = tr * csr - ti * csi;
        v.y = tr * csi + ti * csr;
        V[f] = v;
      }
      const T theta = theta_c * off;
      __syncthreads();                           // stg consumed
      const int nxt = live_from(g, j + 1);
      if (nxt >= 0) fetch(nxt);

      // ---- placement, phase ramp and (shower, ray) sum ------------------------
      placefft::place_row<T, true>(Spectrum<T>{V}, K_int, theta, norm1, p1, p2, E1, E2, w,
                                   K_place);
    }
    placefft::store(w, out_re, out_im, g, K_place);
  }
}

template <typename T>
size_t smem_of(int K_int, int n_sparse, int K_place, int n_int, int n_base) {
  return layout_of<T>(K_int, n_sparse, K_place, n_int, n_base).work.total;
}

// blocks of one launch: as many as fit on the card, at most one per output row
template <typename T>
cudaError_t grid_of(int G_out, size_t smem, int* n_blocks) {
  return fftc::persistent_grid(placement_chain_kernel<T>, NTH, smem, G_out, n_blocks);
}

template <typename T>
int launch(const T* spec_re, const T* spec_im, const T* att_sparse, const T* comb_re,
           const T* comb_im, const uint8_t* mask, const int32_t* tpl_idx, const T* offsets,
           const T* W, const T* tpl_re, const T* tpl_im, const void* table_int,
           const void* table_base, T* out_re, T* out_im, int R, int s2, int K_int,
           int n_sparse, int K_place, int n_int, int n_base, const int* radix_int,
           int nst_int, const int* radix_base, int nst_base, T theta_c, T norm1,
           void* stream) {
  using T2 = typename Vec2<T>::type;
  if (s2 < 1 || R < s2 || R % s2 || K_int < 1 || K_int > n_int / 2 + 1 || K_place < 1 ||
      K_place > n_base / 2 + 1 || n_int < 2 || n_int > n_base)
    return (int)cudaErrorInvalidValue;
  const fftc::Plan p1 = fftc::make_plan(n_int, radix_int, nst_int);
  const fftc::Plan p2 = fftc::make_plan(n_base, radix_base, nst_base);
  if (!fftc::plan_ok(p1) || !fftc::plan_ok(p2)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_of<T>(K_int, n_sparse, K_place, n_int, n_base);
  int n_blocks = 0;
  const cudaError_t err = grid_of<T>(R / s2, smem, &n_blocks);
  if (err != cudaSuccess) return (int)err;
  const ChainArgs<T> args{spec_re, spec_im, att_sparse, comb_re, comb_im, mask,
                          tpl_idx, offsets, W,        tpl_re,  tpl_im};
  placement_chain_kernel<T><<<n_blocks, NTH, smem, (cudaStream_t)stream>>>(
      args, static_cast<const T2*>(table_int), static_cast<const T2*>(table_base), out_re,
      out_im, R, s2, K_int, n_sparse, K_place, theta_c, norm1, p1, p2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// shared memory one block needs: the wrapper refuses sizes beyond a block's
long placement_chain_smem_bytes(int K_int, int n_sparse, int K_place, int n_int, int n_base,
                                int f64) {
  return (long)(f64 ? smem_of<double>(K_int, n_sparse, K_place, n_int, n_base)
                    : smem_of<float>(K_int, n_sparse, K_place, n_int, n_base));
}
// the grid a launch of these sizes uses (blocks), or -1
int placement_chain_grid(int G_out, int K_int, int n_sparse, int K_place, int n_int,
                         int n_base, int f64) {
  int n = 0;
  const cudaError_t err =
      f64 ? grid_of<double>(G_out, smem_of<double>(K_int, n_sparse, K_place, n_int, n_base), &n)
          : grid_of<float>(G_out, smem_of<float>(K_int, n_sparse, K_place, n_int, n_base), &n);
  return err == cudaSuccess ? n : -1;
}

int placement_chain_f32(const float* spec_re, const float* spec_im, const float* att_sparse,
                        const float* comb_re, const float* comb_im, const uint8_t* mask,
                        const int32_t* tpl_idx, const float* offsets, const float* W,
                        const float* tpl_re, const float* tpl_im, const void* table_int,
                        const void* table_base, float* out_re, float* out_im, int R, int s2,
                        int K_int, int n_sparse, int K_place, int n_int, int n_base,
                        const int* radix_int, int nst_int, const int* radix_base,
                        int nst_base, float theta_c, float norm1, void* stream) {
  return launch<float>(spec_re, spec_im, att_sparse, comb_re, comb_im, mask, tpl_idx,
                       offsets, W, tpl_re, tpl_im, table_int, table_base, out_re, out_im, R,
                       s2, K_int, n_sparse, K_place, n_int, n_base, radix_int, nst_int,
                       radix_base, nst_base, theta_c, norm1, stream);
}

int placement_chain_f64(const double* spec_re, const double* spec_im,
                        const double* att_sparse, const double* comb_re,
                        const double* comb_im, const uint8_t* mask, const int32_t* tpl_idx,
                        const double* offsets, const double* W, const double* tpl_re,
                        const double* tpl_im, const void* table_int, const void* table_base,
                        double* out_re, double* out_im, int R, int s2, int K_int,
                        int n_sparse, int K_place, int n_int, int n_base,
                        const int* radix_int, int nst_int, const int* radix_base,
                        int nst_base, double theta_c, double norm1, void* stream) {
  return launch<double>(spec_re, spec_im, att_sparse, comb_re, comb_im, mask, tpl_idx,
                        offsets, W, tpl_re, tpl_im, table_int, table_base, out_re, out_im,
                        R, s2, K_int, n_sparse, K_place, n_int, n_base, radix_int, nst_int,
                        radix_base, nst_base, theta_c, norm1, stream);
}

}  // extern "C"
