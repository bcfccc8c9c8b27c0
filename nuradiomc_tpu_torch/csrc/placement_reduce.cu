// Placement kernel for Hopper (sm_90a) on a materialized voltage spectrum:
// the placement DFT onto the common time base, the sub-bin phase ramp and the
// (shower, ray) reduction, in one pass.
//
// Replaces nuradiomc_tpu/ops/placement_pallas.py::placement_reduce (kernel
// _kernel), the placement of the non-factored chain (birefringence,
// keep_efields), and the baseline and matmul_only epilogues of
// tools/profile_placement_variants.py (kPhase = true / false). Contract (rows
// channel-major, (shower, ray) fastest, s2 consecutive rows per output row):
//
//   Xb[r, k]  = V_re[r, :] @ D_r[:, k] + V_im[r, :] @ D_i[:, k]      (complex)
//   out[g, k] = sum_{j < s2} Xb[g*s2 + j, k] * exp(-2 pi i k df offset[g*s2 + j])
//
// K_place output columns, not the TPU kernel's 128-padded width (a lane-layout
// artifact there). The DFT, phase and reduction are placement_common.cuh, the
// epilogue kernel 1 had before it placed by FFT; the staging is a copy of the
// V rows.
//
// What bounds it on the H100: 8 FLOP per (row, f, k) of plain FMA. On the
// gen2 path (10240 rows per station, K_int 257, K_place 1025, s2 20) that is
// ~2.2e10 FLOP, at the profiling tool's shape (262144 rows, s2 4) ~5.5e11,
// compute-bound against the 67 TFLOP/s FP32 (34 FP64) of the CUDA cores. V is
// read from device memory once per column tile (9 tiles at K_place 1025) and
// staged in shared memory RB rows at a time; each D element loaded from L2
// feeds 4*RB FMAs; the s2 sum stays in registers across a block's chunks, so
// s2 = 20 needs no atomics and no second pass. Tensor cores (wgmma/TMA) are
// later work.

#include "placement_common.cuh"

namespace {

using placement::KT;

// a copy of input rows row0 .. row0 + n - 1 into V
template <typename T, int RB>
struct CopyStage {
  const T* __restrict__ vre;
  const T* __restrict__ vim;
  int K_int;

  __device__ void operator()(typename placement::Vec2<T>::type* V, int row0,
                             int n) const {
    for (int i = threadIdx.x; i < RB * K_int; i += KT) {
      const int r = i / K_int;
      const int f = i - r * K_int;
      typename placement::Vec2<T>::type v;
      v.x = T(0);
      v.y = T(0);
      if (r < n) {
        const size_t o = (size_t)(row0 + r) * K_int + f;
        v.x = vre[o];
        v.y = vim[o];
      }
      V[f * RB + r] = v;
    }
  }
};

template <typename T, int RB, bool kPhase>
__global__ void __launch_bounds__(KT) placement_reduce_kernel(
    CopyStage<T, RB> stage, const T* __restrict__ offsets,
    const T* __restrict__ drr, const T* __restrict__ dri,
    const T* __restrict__ dir_, const T* __restrict__ dii,
    T* __restrict__ out_re, T* __restrict__ out_im,
    int R, int s2, int K_place, T theta_c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* V = reinterpret_cast<typename placement::Vec2<T>::type*>(smem_raw);
  placement::place_block<T, RB, kPhase>(stage, V, offsets, drr, dri, dir_, dii,
                                        out_re, out_im, R, s2, stage.K_int,
                                        K_place, theta_c);
}

template <typename T, int RB, bool kPhase>
int launch(const T* vre, const T* vim, const T* offsets, const T* drr,
           const T* dri, const T* dir_, const T* dii, T* out_re, T* out_im,
           int R, int s2, int K_int, int K_place, T theta_c, void* stream) {
  using T2 = typename placement::Vec2<T>::type;
  const size_t smem = (size_t)RB * K_int * sizeof(T2);
  cudaError_t err = cudaFuncSetAttribute(
      placement_reduce_kernel<T, RB, kPhase>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const CopyStage<T, RB> stage{vre, vim, K_int};
  placement_reduce_kernel<T, RB, kPhase>
      <<<placement::grid_of(R, s2, K_place, RB), KT, smem, (cudaStream_t)stream>>>(
          stage, offsets, drr, dri, dir_, dii, out_re, out_im, R, s2, K_place,
          theta_c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// input rows staged per chunk: the wrapper reads these to check the
// shared-memory size before launching
int placement_reduce_rows_per_block_f32() { return 32; }
int placement_reduce_rows_per_block_f64() { return 16; }

// phase != 0: the placement as contracted; phase == 0: the same without the
// phase ramp (the profiling tool's matmul_only variant)
int placement_reduce_f32(const float* vre, const float* vim,
                         const float* offsets, const float* drr,
                         const float* dri, const float* dir_, const float* dii,
                         float* out_re, float* out_im, int R, int s2, int K_int,
                         int K_place, int phase, float theta_c, void* stream) {
  if (phase)
    return launch<float, 32, true>(vre, vim, offsets, drr, dri, dir_, dii,
                                   out_re, out_im, R, s2, K_int, K_place,
                                   theta_c, stream);
  return launch<float, 32, false>(vre, vim, offsets, drr, dri, dir_, dii,
                                  out_re, out_im, R, s2, K_int, K_place,
                                  theta_c, stream);
}

int placement_reduce_f64(const double* vre, const double* vim,
                         const double* offsets, const double* drr,
                         const double* dri, const double* dir_,
                         const double* dii, double* out_re, double* out_im,
                         int R, int s2, int K_int, int K_place, int phase,
                         double theta_c, void* stream) {
  if (phase)
    return launch<double, 16, true>(vre, vim, offsets, drr, dri, dir_, dii,
                                    out_re, out_im, R, s2, K_int, K_place,
                                    theta_c, stream);
  return launch<double, 16, false>(vre, vim, offsets, drr, dri, dir_, dii,
                                   out_re, out_im, R, s2, K_int, K_place,
                                   theta_c, stream);
}

}  // extern "C"
