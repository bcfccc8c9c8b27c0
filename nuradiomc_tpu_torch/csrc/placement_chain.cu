// Placement chain kernel for Hopper (sm_90a): the factored propagation chain,
// the placement DFT onto the common time base, the sub-bin phase ramp and the
// (shower, ray) reduction, in one pass.
//
// Replaces nuradiomc_tpu/ops/placement_pallas.py::chain_placement_reduce_v3
// (kernel _chain_kernel_v3). Contract (rows channel-major, (shower, ray)
// fastest, s2 consecutive rows per output row):
//
//   att[r, f]  = sum_s att_sparse[r, s] * W[s, f]
//   V[r, f]    = mask[r] ? tpl[tpl_idx[r], f] * comb[r] * spec[r, f] * att[r, f] : 0
//   Xb[r, k]   = Re(V[r, :]) @ D_r[:, k] + Im(V[r, :]) @ D_i[:, k]      (complex)
//   out[g, k]  = sum_{j < s2} Xb[g*s2 + j, k] * exp(-2 pi i k df offset[g*s2 + j])
//
// The mask is a select, not a multiply: a masked row may carry NaN spectra.
// The phase follows trace.time_shift_phase_uniform's factorization
// k = 32a + b, w^k = e^{i theta 32a} e^{i theta b} with theta = c * offset and
// c = -2 pi df rounded to T, so the kernel evaluates the same arguments as the
// plain version (at the headline theta*k reaches ~4.8e3 rad; both sides take
// the same f32 rounding of the argument).
//
// What bounds it on the H100: the DFT is 8 FLOP per (row, f, k); at the
// headline shape (262144 rows, K_int 208, K_place 816) that is ~3.6e11 FLOP
// of plain FMA, compute-bound against the 67 TFLOP/s FP32 (34 FP64) of the
// CUDA cores. The design keeps everything else off the critical path: V is
// built RB rows at a time in shared memory (f-major, so the inner loop reads
// rows at compile-time offsets), each thread owns one output column k and
// keeps RB rows of Xb in registers, so each D element loaded from L2 feeds
// 4*RB FMAs, and the s2 reduction happens in registers across as many RB-row
// chunks as s2 needs (no atomics: the result is deterministic). The DFT,
// phase and reduction are placement_common.cuh, shared with kernel 4.
// Tensor cores (wgmma/TMA) are later work.

#include "placement_common.cuh"

namespace {

using placement::KT;

// the factored chain into V for input rows row0 .. row0 + n - 1
template <typename T, int RB>
struct ChainStage {
  const T *spec_re, *spec_im, *att_sparse, *comb_re, *comb_im;
  const uint8_t* mask;
  const int32_t* tpl_idx;
  const T *W, *tpl_re, *tpl_im;
  int K_int, n_sparse;

  __device__ void operator()(typename placement::Vec2<T>::type* V, int row0,
                             int n) const {
    for (int i = threadIdx.x; i < RB * K_int; i += KT) {
      const int r = i / K_int;
      const int f = i - r * K_int;
      typename placement::Vec2<T>::type v;
      v.x = T(0);
      v.y = T(0);
      if (r < n) {
        const int row = row0 + r;
        if (mask[row]) {
          const T* a = att_sparse + (size_t)row * n_sparse;
          T att = T(0);
          for (int s = 0; s < n_sparse; ++s) att += a[s] * W[(size_t)s * K_int + f];
          const size_t o = (size_t)row * K_int + f;
          const T sr = spec_re[o] * att;
          const T si = spec_im[o] * att;
          const T cr = comb_re[row];
          const T ci = comb_im[row];
          const T csr = cr * sr - ci * si;
          const T csi = cr * si + ci * sr;
          const size_t t = (size_t)tpl_idx[row] * K_int + f;
          const T tr = tpl_re[t];
          const T ti = tpl_im[t];
          v.x = tr * csr - ti * csi;
          v.y = tr * csi + ti * csr;
        }
      }
      V[f * RB + r] = v;
    }
  }
};

template <typename T, int RB>
__global__ void __launch_bounds__(KT) placement_chain_kernel(
    ChainStage<T, RB> stage, const T* __restrict__ offsets,
    const T* __restrict__ drr, const T* __restrict__ dri,
    const T* __restrict__ dir_, const T* __restrict__ dii,
    T* __restrict__ out_re, T* __restrict__ out_im,
    int R, int s2, int K_place, T theta_c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* V = reinterpret_cast<typename placement::Vec2<T>::type*>(smem_raw);
  placement::place_block<T, RB, true>(stage, V, offsets, drr, dri, dir_, dii,
                                      out_re, out_im, R, s2, stage.K_int,
                                      K_place, theta_c);
}

template <typename T, int RB>
int launch(const T* spec_re, const T* spec_im, const T* att_sparse,
           const T* comb_re, const T* comb_im, const uint8_t* mask,
           const int32_t* tpl_idx, const T* offsets, const T* W,
           const T* tpl_re, const T* tpl_im, const T* drr, const T* dri,
           const T* dir_, const T* dii, T* out_re, T* out_im, int R, int s2,
           int K_int, int n_sparse, int K_place, T theta_c, void* stream) {
  using T2 = typename placement::Vec2<T>::type;
  const size_t smem = (size_t)RB * K_int * sizeof(T2);
  cudaError_t err = cudaFuncSetAttribute(
      placement_chain_kernel<T, RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const ChainStage<T, RB> stage{spec_re, spec_im, att_sparse, comb_re, comb_im,
                                mask,    tpl_idx, W,          tpl_re,  tpl_im,
                                K_int,   n_sparse};
  placement_chain_kernel<T, RB>
      <<<placement::grid_of(R, s2, K_place, RB), KT, smem, (cudaStream_t)stream>>>(
          stage, offsets, drr, dri, dir_, dii, out_re, out_im, R, s2, K_place,
          theta_c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// input rows staged per chunk: the wrapper reads these to check the
// shared-memory size before launching
int placement_rows_per_block_f32() { return 32; }
int placement_rows_per_block_f64() { return 16; }

int placement_chain_f32(const float* spec_re, const float* spec_im,
                        const float* att_sparse, const float* comb_re,
                        const float* comb_im, const uint8_t* mask,
                        const int32_t* tpl_idx, const float* offsets,
                        const float* W, const float* tpl_re,
                        const float* tpl_im, const float* drr,
                        const float* dri, const float* dir_, const float* dii,
                        float* out_re, float* out_im, int R, int s2, int K_int,
                        int n_sparse, int K_place, float theta_c,
                        void* stream) {
  return launch<float, 32>(spec_re, spec_im, att_sparse, comb_re, comb_im,
                           mask, tpl_idx, offsets, W, tpl_re, tpl_im, drr, dri,
                           dir_, dii, out_re, out_im, R, s2, K_int, n_sparse,
                           K_place, theta_c, stream);
}

int placement_chain_f64(const double* spec_re, const double* spec_im,
                        const double* att_sparse, const double* comb_re,
                        const double* comb_im, const uint8_t* mask,
                        const int32_t* tpl_idx, const double* offsets,
                        const double* W, const double* tpl_re,
                        const double* tpl_im, const double* drr,
                        const double* dri, const double* dir_,
                        const double* dii, double* out_re, double* out_im,
                        int R, int s2, int K_int, int n_sparse, int K_place,
                        double theta_c, void* stream) {
  return launch<double, 16>(spec_re, spec_im, att_sparse, comb_re, comb_im,
                            mask, tpl_idx, offsets, W, tpl_re, tpl_im, drr,
                            dri, dir_, dii, out_re, out_im, R, s2, K_int,
                            n_sparse, K_place, theta_c, stream);
}

}  // extern "C"
