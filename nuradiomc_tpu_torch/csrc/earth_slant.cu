// The chord integral of a radially layered Earth for Hopper (sm_90a): the
// column density from the surface-entry point to each interaction vertex,
// integrated by the trapezoid rule on fixed sample positions, one chord a
// block, in one launch.
//
// Replaces no pallas_call: the JAX package computes these weights on the
// host too (nuradiomc_tpu/sim/earth_attenuation.py::EarthModel.slant_depth),
// and so does the port's numpy copy (sim/earth_attenuation.py), which stays
// its CPU path. On the host the integral builds an [N, n_samples, 3] array of
// points (16,384 samples a chord in get_path_weight), takes their norms, looks
// up the shell and evaluates the shell's polynomial: seconds for a list of a
// few thousand events, against well under a millisecond of this card.
//
// Contract (N chords, every array contiguous float64):
//
//   ends    [N, 3]   the vertices shifted by the Earth radius (the Earth's
//                    centre at the origin)
//   dirs    [N, 3]   unit directions from the vertex toward the source
//   dist    [N]      the chord lengths to the surface (0 where none)
//   ts      [S]      the sample positions on [0, 1] (np.linspace(0, 1, S)),
//                    S >= 2
//   shells           n <= ES_MAX_SHELLS outer radii (ascending) and their
//                    (n, 4) polynomial coefficients in x = r / earth_radius
//   out     [N]      the column densities
//
// Each sample is computed as the numpy copy computes it, operation for
// operation: the point endpoint + ((t * dist) * d), the radius
// sqrt((x*x + y*y) + z*z), the shell as the count of radii <= r (numpy's
// searchsorted(side="right")) with zero density outside the outer shell, the
// Horner polynomial c0 + x (c1 + x (c2 + x c3)) in x = r / earth_radius, and
// the trapezoid term ((t_{i+1} - t_i) (rho_{i+1} + rho_i)) / 2. The build
// compiles this file with -fmad=false (ops/_build.py), and CUDA's float64
// division and square root round correctly, so every term has numpy's bits;
// only the order of the sum differs from np.trapz's pairwise one. The chord
// integral times dist is the result (0 where dist is 0).
//
// What bounds it on the H100: float64 arithmetic. A sample costs ~25 float64
// operations plus a compare a shell, a square root and a division; the block
// reads 48 bytes of its chord, the shared sample positions (128 KB, from L2)
// and writes 8. Nothing of size [N, S] is ever stored.
//
// The design: one block of 256 threads a chord. Each thread walks a
// contiguous run of ceil((S - 1) / 256) terms, so it evaluates the density at
// one sample more than its terms and carries rho_{i+1} on as the next
// rho_i. The partial sums are reduced by a fixed warp-shuffle tree and then
// summed warp by warp by one thread: no atomics, so the same input gives the
// same bits on every run. The shell table is a kernel parameter, copied into
// shared memory at the block's start.

#include <cuda_runtime.h>
#include <math.h>

#define ES_MAX_SHELLS 16

namespace {

constexpr int NTH = 256;   // threads per block (one block a chord)
constexpr int NWARP = NTH / 32;

struct Shells {
  double radii[ES_MAX_SHELLS];
  double coeffs[ES_MAX_SHELLS * 4];
  double earth_radius;
  int n;
};

__device__ __forceinline__ double density(double r, const double* radii, const double* coeffs,
                                          int n, double earth_radius) {
  int shell = 0;
  for (int k = 0; k < n; ++k) shell += (radii[k] <= r) ? 1 : 0;
  if (shell >= n) return 0.0;
  const double* c = coeffs + 4 * shell;
  const double x = r / earth_radius;
  return c[0] + x * (c[1] + x * (c[2] + x * c[3]));
}

__global__ void __launch_bounds__(NTH)
earth_slant_kernel(const double* __restrict__ ends, const double* __restrict__ dirs,
                   const double* __restrict__ dist, const double* __restrict__ ts,
                   int n_samples, const Shells shells, double* __restrict__ out) {
  __shared__ double s_radii[ES_MAX_SHELLS];
  __shared__ double s_coeffs[ES_MAX_SHELLS * 4];
  __shared__ double s_warp[NWARP];
  const int tid = threadIdx.x;
  const long chord = blockIdx.x;
  if (tid < ES_MAX_SHELLS) s_radii[tid] = shells.radii[tid];
  if (tid < ES_MAX_SHELLS * 4) s_coeffs[tid] = shells.coeffs[tid];
  __syncthreads();

  const int n = shells.n;
  const double R = shells.earth_radius;
  const double ex = ends[3 * chord], ey = ends[3 * chord + 1], ez = ends[3 * chord + 2];
  const double dx = dirs[3 * chord], dy = dirs[3 * chord + 1], dz = dirs[3 * chord + 2];
  const double L = dist[chord];

  const int n_terms = n_samples - 1;
  const int per = (n_terms + NTH - 1) / NTH;
  const int i0 = min(tid * per, n_terms);
  const int i1 = min(i0 + per, n_terms);
  double sum = 0.0;
  if (i0 < i1) {
    double t_prev = ts[i0];
    double tl = t_prev * L;
    double px = ex + tl * dx, py = ey + tl * dy, pz = ez + tl * dz;
    double rho_prev = density(sqrt((px * px + py * py) + pz * pz), s_radii, s_coeffs, n, R);
    for (int i = i0; i < i1; ++i) {
      const double t_next = ts[i + 1];
      tl = t_next * L;
      px = ex + tl * dx;
      py = ey + tl * dy;
      pz = ez + tl * dz;
      const double rho_next =
          density(sqrt((px * px + py * py) + pz * pz), s_radii, s_coeffs, n, R);
      sum += ((t_next - t_prev) * (rho_next + rho_prev)) / 2.0;
      t_prev = t_next;
      rho_prev = rho_next;
    }
  }
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
  if ((tid & 31) == 0) s_warp[tid >> 5] = sum;
  __syncthreads();
  if (tid == 0) {
    double total = 0.0;
    for (int w = 0; w < NWARP; ++w) total += s_warp[w];
    out[chord] = total * L;
  }
}

}  // namespace

extern "C" {

int earth_slant_max_shells() { return ES_MAX_SHELLS; }

// radii [n_shells] and coeffs [n_shells, 4] are host memory, read before the
// launch returns; the other pointers are device memory. Returns the launch's
// cudaError_t (cudaErrorInvalidValue for arguments outside the contract).
int earth_slant_f64(const double* ends, const double* dirs, const double* dist, const double* ts,
                    long n_chords, int n_samples, const double* radii, const double* coeffs,
                    int n_shells, double earth_radius, double* out, void* stream) {
  if (n_shells < 1 || n_shells > ES_MAX_SHELLS || n_samples < 2 || n_chords < 0 ||
      n_chords > 0x7fffffffL)
    return cudaErrorInvalidValue;
  if (n_chords == 0) return cudaSuccess;
  Shells shells;
  for (int k = 0; k < ES_MAX_SHELLS; ++k) {
    shells.radii[k] = k < n_shells ? radii[k] : 0.0;
    for (int j = 0; j < 4; ++j) shells.coeffs[4 * k + j] = k < n_shells ? coeffs[4 * k + j] : 0.0;
  }
  shells.earth_radius = earth_radius;
  shells.n = n_shells;
  earth_slant_kernel<<<(unsigned)n_chords, NTH, 0, (cudaStream_t)stream>>>(
      ends, dirs, dist, ts, n_samples, shells, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
