// The analytic in-ice two-point ray solver for Hopper (sm_90a): both
// solutions of a (source, receiver) pair in the exponential ice profile
// n(z) = n_ice - delta_n exp((z - z_shift) / z_0), sorted by C0, with their
// closed-form observables, in one launch.
//
// Replaces no pallas_call: the JAX package's solver is
// nuradiomc_tpu/ops/raytrace.py::find_solutions (:875) under vmap, whose
// bisections, secant polish and golden-section search are lax.fori_loops that
// XLA fuses. The port's plain version, ops/raytrace.py::find_solutions_plain,
// writes each iterate as a few dozen PyTorch elementwise ops over the whole
// batch: ~47k launches a solve, whatever the batch size. This kernel is those
// loops in registers, one thread a pair.
//
// Contract (N pairs, every array contiguous, one dtype):
//
//   x1y, x1z, x2y, x2z   [N]      the 2D geometry of ops/raytrace.to_2d
//                                 (x2 above-or-level with x1, x2y >= x1y)
//   c0, c1, launch, receive, path, ttime   [N, 2]   (float / double)
//   mask                 [N, 2]   uint8 (torch.bool storage)
//   sol_type, reflection, refl_case        [N, 2]   int32
//   s[RS_NSCALARS]       the ice model's scalars and the solver's constants,
//                        each as the plain version's ATen ops see it (below)
//   n_narrow, n_secant   the bisection / secant split of n_bisect
//
// The work is the plain version's, iterate for iterate: the direct-branch
// bracketed solve (n_narrow bisections, then n_secant clamped secant steps),
// 48 golden-section steps on the mirror branch (both interior points each
// step), the two mirror bracketed solves, the tangent rule, the stable sort by
// C0 with invalid slots last, then per slot C1, the solution type, the launch
// and receive angles and Bouma's path length and travel time. Each operation
// is written as ATen computes it on the card, so that the kernel's numbers
// equal the plain version's there bit for bit wherever both reach the same
// libdevice function: a Python scalar is rounded to the tensor's dtype before
// it enters an op (the wrapper hands them over that way); x / scalar is
// x * (1 / scalar) with the reciprocal rounded on the host; scalar / x is
// reciprocal(x) * scalar; x ** 2 is x * x and x ** -2 is 1.0 / (x * x) in
// double; clamp and minimum / maximum propagate NaN; sign is 0 for 0 and NaN.
// The build compiles this file with -fmad=false: a contracted a * b + c
// would round once where the plain version rounds twice (ops/_build.py).
// Near a turning point the solver's objective amplifies a last-bit
// difference to ~1e-8 in C0 and ~2e-7 in the path length. Where the plain
// version evaluates the same value twice (a branch miss of a trial C0, the
// turning point, the solution type), the kernel evaluates it once: the same
// bits.
//
// What bounds it on the H100: FP64 throughput. A pair reads 32 bytes and
// writes 2 x 61; its ~390 evaluations of a branch miss (each an exp, two to
// three logs, four to six square roots and divisions) are 46,258 of the
// plain version's float64 operations at n_bisect 96 (a transcendental
// counting one; ~2e5 FP64 instructions), with no shared memory and no data
// reuse.
//
// The design: one thread a pair, 128 threads a block, everything in
// registers. Every loop count is fixed by n_bisect, and each of the plain
// version's torch.where is a select, so the threads of a warp never diverge;
// the only memory traffic is the four coalesced input loads and the ten
// output stores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTH = 128;   // threads per block

// the scalars, in the order of the wrapper's array
enum {
  S_N, S_DN, S_Z0, S_ZS, S_NN, S_B, S_QBB, S_HB, S_INV_N, S_INV_Z0, S_INV_DN, S_G_SURF,
  S_INV_C, S_PI, S_EPS, S_TINY, S_TOL, S_INV_PHI, S_HI, RS_NSCALARS
};

template <typename T>
struct Params {
  T n;        // n_ice
  T dn;       // delta_n
  T z0;       // z_0
  T zs;       // z_shift
  T nn;       // n_ice ** 2
  T b;        // 2 n_ice
  T qbb;      // 0.25 b b
  T hb;       // 0.5 b
  T inv_n;    // 1 / n_ice
  T inv_z0;   // 1 / z_0 rounded in T (ATen's x / scalar)
  T inv_dn;   // 1 / delta_n rounded in T
  T g_surf;   // delta_n exp(-z_shift / z_0): gamma at the surface
  T inv_c;    // 1 / speed of light rounded in T
  T pi;
  T eps;      // the lower bracket's offset (1e-12 in float64, 1e-5 in float32)
  T tiny;     // 1e-30
  T tol;      // |miss| accepted for a tangent solution
  T inv_phi;  // golden-section ratio
  T hi;       // upper logC0 bracket
  int n_narrow, n_secant;
};

__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_atan(double x) { return atan(x); }
__device__ __forceinline__ float m_atan(float x) { return atanf(x); }
__device__ __forceinline__ double m_sin(double x) { return sin(x); }
__device__ __forceinline__ float m_sin(float x) { return sinf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_fmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float m_fmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double m_fmin(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float m_fmin(float a, float b) { return fminf(a, b); }

// torch.clamp(v, min=lo): NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) { return isnan(v) ? v : m_fmax(v, lo); }
// torch.minimum / torch.maximum: a NaN operand wins
template <typename T>
__device__ __forceinline__ T t_min(T a, T b) { return isnan(a) ? a : (isnan(b) ? b : m_fmin(a, b)); }
template <typename T>
__device__ __forceinline__ T t_max(T a, T b) { return isnan(a) ? a : (isnan(b) ? b : m_fmax(a, b)); }
// torch.sign: -1, 0 (for 0 and NaN), 1
template <typename T>
__device__ __forceinline__ int sgn(T x) { return (T(0) < x) - (x < T(0)); }
// x ** -2 (ATen's pow_tensor_scalar: 1.0 / (x * x), the 1.0 a double)
template <typename T>
__device__ __forceinline__ T inv_sq(T x) { return static_cast<T>(1.0 / (x * x)); }
// torch.reciprocal
template <typename T>
__device__ __forceinline__ T rcp(T x) { return T(1) / x; }

// gamma(z) = delta_n exp((z - z_shift) / z_0)
template <typename T>
__device__ __forceinline__ T gamma_of(T z, const Params<T>& p) {
  return m_exp((z - p.zs) * p.inv_z0) * p.dn;
}

// what the closed-form path y(gamma) needs of C0 alone
template <typename T>
struct Ray {
  T c;            // n_ice^2 - C0^-2
  T two_sqrt_c;   // 2 sqrt(c)
  T two_c;        // 2 c
  T coef;         // z_0 / sqrt(n_ice^2 C0^2 - 1)
};

template <typename T>
__device__ __forceinline__ Ray<T> ray_of(T c0, const Params<T>& p) {
  Ray<T> r;
  r.c = p.nn - inv_sq(c0);
  r.two_sqrt_c = T(2) * m_sqrt(r.c);
  r.two_c = T(2) * r.c;
  r.coef = rcp(m_sqrt((c0 * c0) * p.nn - T(1))) * p.z0;
  return r;
}

// y(gamma) - C1 (get_y): the coefficient times log of the argument
template <typename T>
__device__ __forceinline__ T y_log(T g, const Ray<T>& r, const Params<T>& p) {
  const T root = m_abs((g * g - g * p.b) + r.c);
  const T arg = g / ((r.two_sqrt_c * m_sqrt(root) - g * p.b) + r.two_c);
  return r.coef * m_log(arg);
}

// the turning point (gamma, z), a saddle above the surface moved to z = 0
template <typename T>
__device__ __forceinline__ void turn_of(const Ray<T>& r, const Params<T>& p, T& gamma, T& z) {
  const T disc = m_sqrt(clamp_min(p.qbb - r.c, T(0)));
  const T g2 = r.c / (disc + p.hb);
  const T z2 = m_log(g2 * p.inv_dn) * p.z0 + p.zs;
  const bool above = z2 > T(0);
  z = above ? T(0) : z2;
  gamma = above ? p.g_surf : g2;
}

// one pair's geometry and what the misses need of it
template <typename T>
struct Pair {
  T x1y, x1z, x2y, x2z;
  T g1, g2;   // gamma(x1z), gamma(x2z)
  T dy;       // x2y - x1y
};

// miss of the direct branch for trial logC0
template <typename T>
struct MissDirect {
  const Pair<T>& q;
  const Params<T>& p;
  __device__ __forceinline__ T operator()(T lg) const {
    const Ray<T> r = ray_of(m_exp(lg) + p.inv_n, p);
    const T w1 = y_log(q.g1, r, p) + T(0);
    const T w2 = y_log(q.g2, r, p) + T(0);
    return q.dy - (w2 - w1);
  }
};

// miss of the mirrored (past the turning point) branch for trial logC0
template <typename T>
struct MissMirror {
  const Pair<T>& q;
  const Params<T>& p;
  __device__ __forceinline__ T operator()(T lg) const {
    const Ray<T> r = ray_of(m_exp(lg) + p.inv_n, p);
    T g_turn, z_turn;
    turn_of(r, p, g_turn, z_turn);
    const T w1 = y_log(q.g1, r, p) + T(0);
    const T w2 = y_log(q.g2, r, p) + T(0);
    const T wt = y_log(gamma_of(z_turn, p), r, p) + T(0);
    return q.dy - ((T(2) * wt - w2) - w1);
  }
};

// root of a sign-changing f on [lo, hi] (f_lo = f(lo), f_hi = f(hi)):
// bisection, then the bracket-clamped secant polish. f(a), f(b) of the polish
// are the values the bisection already computed at the final ends.
template <typename T, typename F>
__device__ __forceinline__ T bracketed_solve(const F& f, T lo, T hi, T f_lo, T f_hi,
                                             const Params<T>& p) {
  const int s_lo = sgn(f_lo);
  for (int i = 0; i < p.n_narrow; ++i) {
    const T mid = (lo + hi) * T(0.5);
    const T fm = f(mid);
    const bool same = sgn(fm) == s_lo;
    lo = same ? mid : lo;
    f_lo = same ? fm : f_lo;
    hi = same ? hi : mid;
    f_hi = same ? f_hi : fm;
  }
  if (p.n_secant == 0) return (lo + hi) * T(0.5);
  T a = lo, b = hi, fa = f_lo, fb = f_hi;
  for (int i = 0; i < p.n_secant; ++i) {
    const T denom = fb - fa;
    const T safe = m_abs(denom) > p.tiny ? denom : p.tiny;
    T x = b - (fb * (b - a)) / safe;
    x = t_min(t_max(x, t_min(a, b)), t_max(a, b));
    const T fx = f(x);
    const bool same = sgn(fx) == s_lo;
    a = same ? x : a;
    fa = same ? fx : fa;
    b = same ? b : x;
    fb = same ? fb : fx;
  }
  return (a + b) * T(0.5);
}

// argmin of a unimodal f on [lo, hi] by 48 golden-section steps
template <typename T, typename F>
__device__ __forceinline__ T golden_min(const F& f, T lo, T hi, const Params<T>& p) {
  T a = lo, b = hi;
  T c = b - (b - a) * p.inv_phi;
  T d = a + (b - a) * p.inv_phi;
  T fc = f(c), fd = f(d);
  for (int i = 0; i < 48; ++i) {
    // <= keeps the minimum on the left of a flat plateau
    const bool left = fc <= fd;
    const T a2 = left ? a : c;
    const T b2 = left ? d : b;
    c = b2 - (b2 - a2) * p.inv_phi;
    d = a2 + (b2 - a2) * p.inv_phi;
    a = a2;
    b = b2;
    fc = f(c);
    fd = f(d);
  }
  return (a + b) * T(0.5);
}

// |dy/dz| at refractive index nz
template <typename T>
__device__ __forceinline__ T dy_dz(T nz, T c0, const Params<T>& p) {
  const T arg = (c0 * c0) * (nz * nz) - T(1);
  return arg > T(0) ? rcp(m_sqrt(clamp_min(arg, p.tiny))) * T(1) : T(INFINITY);
}

// one slot's closed-form observables at root logC0
template <typename T>
__device__ __forceinline__ void observables(T lg, bool valid, const Pair<T>& q,
                                            const Params<T>& p, size_t o, T* c0_out,
                                            T* c1_out, uint8_t* mask_out, int* sol_out,
                                            T* launch_out, T* receive_out, T* path_out,
                                            T* ttime_out, int* refl_out, int* case_out) {
  const T c0 = m_exp(lg) + p.inv_n;
  const Ray<T> r = ray_of(c0, p);
  T g_turn, z_turn;
  turn_of(r, p, g_turn, z_turn);
  // C1 = x1y - y(x1z), mirrored past the turning point
  const T l_turn = y_log(g_turn, r, p);
  const T y_below = y_log(q.g1, r, p) + T(0);
  const T y_above = T(2) * (l_turn + T(0))
                    - (y_log(gamma_of(T(2) * z_turn - q.x1z, p), r, p) + T(0));
  const T c1 = q.x1y - (q.x1z < z_turn ? y_below : y_above);
  const T y_turn = l_turn + c1;
  const int sol = q.x2y < y_turn ? 1 : (z_turn >= T(0) ? 3 : 2);
  // launch and receive zeniths
  const T n1 = p.n - q.g1;
  const T la = m_atan(dy_dz(n1, c0, p));
  const T z2m = y_turn < q.x2y ? (q.x1z + m_abs(z_turn - q.x1z)) + m_abs(z_turn - q.x2z) : q.x2z;
  T ang = m_atan(dy_dz(p.n - q.g2, c0, p));
  ang = z2m != q.x2z ? p.pi - ang : ang;
  const T ra = p.pi - ang;
  // Bouma's path length s(z) and travel time c t(z)
  const T beta = n1 * m_sin(la);
  const T bb = beta * beta;
  const T alpha = p.nn - bb;
  const T sa = m_sqrt(alpha);
  const T n_sa = rcp(sa) * p.n;
  const T nn_sa = rcp(sa) * p.nn;
  T s[3], ct[3];
  const T zt = sol == 3 ? T(0) : z_turn;
  const T zs[3] = {q.x1z, q.x2z, zt};
  const T gs[3] = {q.g1, q.g2, gamma_of(zt, p)};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T nz = p.n - gs[k];
    const T gam = clamp_min(nz * nz - bb, T(0));
    const T sg = m_sqrt(gam);
    const T log1 = m_log((m_sqrt(alpha * gam) + nz * p.n) - bb);
    const T log2 = m_log(sg + nz);
    s[k] = n_sa * (zs[k] - log1 * p.z0) + log2 * p.z0;
    ct[k] = ((sg - nn_sa * log1) + log2 * p.n) * p.z0 + (zs[k] * p.nn) / sa;
  }
  const bool direct = sol == 1;
  c0_out[o] = c0;
  c1_out[o] = c1;
  mask_out[o] = valid ? 1 : 0;
  sol_out[o] = valid ? sol : 0;
  launch_out[o] = la;
  receive_out[o] = ra;
  path_out[o] = direct ? s[1] - s[0] : (T(2) * s[2] - s[0]) - s[1];
  ttime_out[o] = (direct ? ct[1] - ct[0] : (T(2) * ct[2] - ct[0]) - ct[1]) * p.inv_c;
  refl_out[o] = 0;
  case_out[o] = 1;
}

template <typename T>
__global__ void __launch_bounds__(NTH) ray_solver_kernel(
    const T* __restrict__ x1y, const T* __restrict__ x1z, const T* __restrict__ x2y,
    const T* __restrict__ x2z, T* __restrict__ c0, T* __restrict__ c1,
    uint8_t* __restrict__ mask, int* __restrict__ sol_type, T* __restrict__ launch,
    T* __restrict__ receive, T* __restrict__ path, T* __restrict__ ttime,
    int* __restrict__ reflection, int* __restrict__ refl_case, long n, const Params<T> p) {
  const long i = (long)blockIdx.x * NTH + threadIdx.x;
  if (i >= n) return;
  Pair<T> q;
  q.x1y = x1y[i];
  q.x1z = x1z[i];
  q.x2y = x2y[i];
  q.x2z = x2z[i];
  q.g1 = gamma_of(q.x1z, p);
  q.g2 = gamma_of(q.x2z, p);
  q.dy = q.x2y - q.x1y;
  const MissDirect<T> f_direct{q, p};
  const MissMirror<T> f_mirror{q, p};

  // logC0 of the ray that turns exactly at the receiver depth, and 100
  const T c0_min = rcp(m_sqrt(p.nn - q.g2 * (p.b - q.g2))) * T(1);
  const T lo0 = m_log(c0_min - p.inv_n) + p.eps;
  const T hi0 = p.hi;

  const T fd_lo = f_direct(lo0);
  const T fd_hi = f_direct(hi0);
  const bool has_direct = sgn(fd_lo) != sgn(fd_hi);
  const T r_direct = bracketed_solve(f_direct, lo0, hi0, fd_lo, fd_hi, p);

  const T mid = golden_min(f_mirror, lo0, hi0, p);
  const T fm_lo = f_mirror(lo0);
  const T fm_mid = f_mirror(mid);
  const T fm_hi = f_mirror(hi0);
  const bool has_m_hi = sgn(fm_mid) != sgn(fm_hi);
  const T r_m_hi = bracketed_solve(f_mirror, mid, hi0, fm_mid, fm_hi, p);
  const bool has_m_lo = (sgn(fm_lo) != sgn(fm_mid)) && !has_direct;
  const T r_m_lo = bracketed_solve(f_mirror, lo0, mid, fm_lo, fm_mid, p);

  const bool tangent = !has_direct && !has_m_lo && (m_abs(fd_lo) < p.tol);
  T root0 = has_direct ? r_direct : (has_m_lo ? r_m_lo : lo0);
  bool valid0 = has_direct || has_m_lo || tangent;
  T root1 = r_m_hi;
  bool valid1 = has_m_hi;

  // stable ascending sort by C0, invalid slots (+inf) last, NaN after +inf
  const T k0 = valid0 ? root0 : T(INFINITY);
  const T k1 = valid1 ? root1 : T(INFINITY);
  if (!isnan(k1) && (isnan(k0) || k1 < k0)) {
    const T rt = root0;
    root0 = root1;
    root1 = rt;
    const bool vt = valid0;
    valid0 = valid1;
    valid1 = vt;
  }
  observables(root0, valid0, q, p, 2 * (size_t)i, c0, c1, mask, sol_type, launch, receive,
              path, ttime, reflection, refl_case);
  observables(root1, valid1, q, p, 2 * (size_t)i + 1, c0, c1, mask, sol_type, launch, receive,
              path, ttime, reflection, refl_case);
}

template <typename T>
int launch(const T* x1y, const T* x1z, const T* x2y, const T* x2z, T* c0, T* c1,
           uint8_t* mask, int* sol_type, T* launch_angle, T* receive_angle, T* path,
           T* ttime, int* reflection, int* refl_case, long n, const double* s, int n_narrow,
           int n_secant, void* stream) {
  Params<T> p;
  p.n = (T)s[S_N];
  p.dn = (T)s[S_DN];
  p.z0 = (T)s[S_Z0];
  p.zs = (T)s[S_ZS];
  p.nn = (T)s[S_NN];
  p.b = (T)s[S_B];
  p.qbb = (T)s[S_QBB];
  p.hb = (T)s[S_HB];
  p.inv_n = (T)s[S_INV_N];
  p.inv_z0 = (T)s[S_INV_Z0];
  p.inv_dn = (T)s[S_INV_DN];
  p.g_surf = (T)s[S_G_SURF];
  p.inv_c = (T)s[S_INV_C];
  p.pi = (T)s[S_PI];
  p.eps = (T)s[S_EPS];
  p.tiny = (T)s[S_TINY];
  p.tol = (T)s[S_TOL];
  p.inv_phi = (T)s[S_INV_PHI];
  p.hi = (T)s[S_HI];
  p.n_narrow = n_narrow;
  p.n_secant = n_secant;
  const long blocks = (n + NTH - 1) / NTH;
  ray_solver_kernel<T><<<(unsigned)blocks, NTH, 0, (cudaStream_t)stream>>>(
      x1y, x1z, x2y, x2z, c0, c1, mask, sol_type, launch_angle, receive_angle, path, ttime,
      reflection, refl_case, n, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ray_solver_nscalars() { return RS_NSCALARS; }

int ray_solver_f32(const float* x1y, const float* x1z, const float* x2y, const float* x2z,
                   float* c0, float* c1, uint8_t* mask, int* sol_type, float* launch_angle,
                   float* receive_angle, float* path, float* ttime, int* reflection,
                   int* refl_case, long n, const double* scalars, int n_narrow, int n_secant,
                   void* stream) {
  return launch<float>(x1y, x1z, x2y, x2z, c0, c1, mask, sol_type, launch_angle, receive_angle,
                       path, ttime, reflection, refl_case, n, scalars, n_narrow, n_secant,
                       stream);
}

int ray_solver_f64(const double* x1y, const double* x1z, const double* x2y, const double* x2z,
                   double* c0, double* c1, uint8_t* mask, int* sol_type, double* launch_angle,
                   double* receive_angle, double* path, double* ttime, int* reflection,
                   int* refl_case, long n, const double* scalars, int n_narrow, int n_secant,
                   void* stream) {
  return launch<double>(x1y, x1z, x2y, x2z, c0, c1, mask, sol_type, launch_angle,
                        receive_angle, path, ttime, reflection, refl_case, n, scalars, n_narrow,
                        n_secant, stream);
}

}  // extern "C"
