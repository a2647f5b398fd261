// Whole-rollout batched 6-dof RK4 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel elodin_tpu/ops/sixdof_kernel.py::_kernel
// (launched by _rollout): N independent rigid bodies under central gravity,
// body-frame +x thrust and +z torque and quadratic drag, integrated for a
// runtime number of RK4 ticks in ONE launch.  Per tick, four stages of the
// effector + sixdof_accel algebra and the normalized quaternion update of
// stf_add_motion; the same stage sequence as six_dof._rk4.
//
// Layout: one thread a body.  The 13 state and 4 parameter values are loaded
// once into registers, the whole tick loop runs in the thread, and the final
// state is stored once, so device memory is touched twice a rollout.
// Channel-major (13, N) state and (4, N) parameters, so neighbouring threads
// read neighbouring addresses; the kernel masks the ragged edge itself.
// Templated on float (the counterpart of the f32-only TPU kernel) and double
// (Hopper has native FP64, so the kernel is held directly against the f64
// ECS path).
//
// What the function needs.  sixdof_accel takes a world force and torque
// into the body frame (R^T), divides by the mass and the inertia, and
// takes the result back to the world (R).  R is a rotation, so R R^T = I:
// the world force over the mass is the linear acceleration itself, and the
// body +z torque, R e_z T m, comes back as R e_z T m / Izz.  So a stage
// needs two columns of R, R e_x and R e_z, and no frame round trip.  Per
// body-tick that is 511 FP32 operations (607 in FP64, an FMA counted as
// 2) and 13 SFU results: chip_smoke.py's SIXDOF_TICK_OPS spells the count
// out.  Memory is nothing (30 values a body a rollout).
// * f32 is bound by instruction issue: a scheduler issues one warp
//   instruction a clock, so at a width that fills the card the time is the
//   tick loop's instruction count.
// * f64 is bound by the FP64 pipe (half the FP32 rate): the same count in
//   FP64 instructions.
// * Under about one warp a scheduler (8192 bodies on 132 SMs) a warp's own
//   issue sets the time: it issues at most one instruction a clock, so
//   the tick loop's length is the floor, and half the schedulers idle.
//
// What the design does about it (scripts/sixdof_plan_sweep.py times it
// against an older copy on the card; PERF.md holds the numbers):
// * No frame round trip: a stage builds R e_x and R e_z of R = M / |n|^2
//   from the unnormalized quaternion n of set_u (R depends on n's
//   direction alone, so the stage's normalization is left out; the
//   state's quaternion is still normalized once a tick), from one
//   reciprocal and 2 n_i / |n|^2.  The angular acceleration is
//   (T m / Izz) R e_z, the linear one -mu r / |r|^3 + thrust R e_x -
//   (drag / m) |v| v.
// * What is constant for a body is hoisted out of the tick loop: T m / Izz
//   and drag / m (m = 1/inv_m, the one IEEE divide).
// * Reciprocals and reciprocal square roots are the SFU's approximations
//   (rcp.approx / rsqrt.approx, MUFU.RCP64H / MUFU.RSQ64H) with, in f64,
//   one cubic refinement step: branch-free, no IEEE slow path.  |v| is
//   v^2 rsqrt(max(v^2, min normal)), so a body at rest gets exactly zero
//   drag (0 times a finite number), never 0 * inf.
// * Every product feeds an add as an FMA, written out with the _rn
//   intrinsics, so the rounding is the source's and not the compiler's
//   choice of contraction.  A thread's arithmetic does not depend on the
//   block it runs in, so a body's result is the same bits whatever the
//   launch plan (the sharded and rank forms are held bitwise to one card).
// * The block size comes from ops/sixdof_kernel.py::_launch_plan (N and
//   the SM count): 128 threads, fewer where that would leave SMs without a
//   block.  The registers are ptxas's choice (one block an SM asked for).
//
// Accuracy: the kernel agrees with the plain PyTorch version to rounding
// (f32 ≤ 1e-4, f64 ≤ 1e-12 max|Δ|/max|ref| a channel group over a
// rollout); the SFU seeds are within 2 ulp in f32, and the f64 cubic step
// brings them to about an ulp.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (no --use_fast_math).

#include <cfloat>

#include <cuda_runtime.h>

namespace {

constexpr int kState = 13;  // qx qy qz qw | px py pz | wx wy wz | vx vy vz
// (and four parameters a body: 1/ixx 1/iyy 1/izz 1/m)
constexpr int kMinThreads = 32, kMaxThreads = 256;

// Arithmetic with the rounding written out: no contraction, no reordering.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_(double a, double b) { return fmax(a, b); }
template <typename T> __device__ __forceinline__ T min_normal();
template <> __device__ __forceinline__ float min_normal<float>() { return FLT_MIN; }
template <> __device__ __forceinline__ double min_normal<double>() { return DBL_MIN; }

// 1/x and 1/sqrt(x) for a normal positive x, branch-free.
__device__ __forceinline__ float rcp_fast(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ double rcp_fast(double x) {
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  const double e = __fma_rn(-x, y, 1.0);
  return __fma_rn(__fma_rn(e, e, e), y, y);
}

__device__ __forceinline__ float rsqrt_fast(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ double rsqrt_fast(double x) {
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  const double e = __fma_rn(-__dmul_rn(y, y), x, 1.0);
  return __fma_rn(__fma_rn(e, 0.375, 0.5), __dmul_rn(y, e), y);
}

template <typename T>
struct Consts {
  T neg_mu, thrust, torque, neg_drag;  // effector constants
  T f_half, h_half;                    // 0.5*dt and 0.5*(0.5*dt)
  T f_full, h_full;                    // dt and 0.5*dt
  T f_sixth, h_sixth;                  // dt/6 and 0.5*dt/6: the final update
};

// What stays constant for a body over the ticks.
template <typename T>
struct Body {
  T neg_drag_m;  // -drag / m: the drag's acceleration over |v| v
  T spin;        // torque m / Izz: the body +z torque's angular acceleration
};

// A body's constants from its parameters (m = 1/inv_m, the one IEEE
// divide).  1/Ixx and 1/Iyy take no part: the torque is about the body z
// axis and the inertia diagonal, so only Izz turns it into spin.
template <typename T>
__device__ __forceinline__ Body<T> body(const T* __restrict__ par, size_t stride, int i,
                                        const Consts<T>& c) {
  const T inv_m = par[3 * stride + i];
  const T m = T(1) / inv_m;
  return {mul(c.neg_drag, inv_m), mul(mul(c.torque, m), par[2 * stride + i])};
}

// The columns R e_x and R e_z of R = M(n) / |n|^2, the rotation matrix of
// the attitude n at any nonzero scale (spatial._quat_homog_mat over |q|^2):
// the body's thrust and torque axes in the world.
template <typename T>
__device__ __forceinline__ void axes(const T n[4], T ex[3], T ez[3]) {
  const T n2 = fma_(n[3], n[3], fma_(n[2], n[2], fma_(n[1], n[1], mul(n[0], n[0]))));
  const T s = mul(T(2), rcp_fast(n2));
  const T sx = mul(n[0], s), sy = mul(n[1], s), sz = mul(n[2], s), sw = mul(n[3], s);
  const T xy = mul(n[0], sy), xz = mul(n[0], sz), yz = mul(n[1], sz);
  ex[0] = fma_(-n[1], sy, fma_(-n[2], sz, T(1)));
  ex[1] = fma_(n[2], sw, xy);
  ex[2] = fma_(-n[1], sw, xz);
  ez[0] = fma_(n[1], sw, xz);
  ez[1] = fma_(-n[0], sw, yz);
  ez[2] = fma_(-n[0], sx, fma_(-n[1], sy, T(1)));
}

// The stage's accelerations at attitude n, position p and velocity v:
// angular (T m / Izz) R e_z; linear -mu p / |p|^3 + thrust R e_x - (drag /
// m) |v| v.
template <typename T>
__device__ __forceinline__ void accel(const T n[4], const T p[3], const T v[3],
                                      const Body<T>& b, const Consts<T>& c, T aw[3],
                                      T av[3]) {
  T ex[3], ez[3];
  axes(n, ex, ez);
  const T ir = rsqrt_fast(fma_(p[2], p[2], fma_(p[1], p[1], mul(p[0], p[0]))));
  const T g = mul(c.neg_mu, mul(mul(ir, ir), ir));
  const T v2 = fma_(v[2], v[2], fma_(v[1], v[1], mul(v[0], v[0])));
  const T d = mul(b.neg_drag_m, mul(v2, rsqrt_fast(max_(v2, min_normal<T>()))));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    aw[k] = mul(b.spin, ez[k]);
    av[k] = fma_(g, p[k], fma_(c.thrust, ex[k], mul(d, v[k])));
  }
}

// n := q0 + (h*dw, 0) * q0, stf_add_motion's attitude update before its
// normalization.
template <typename T>
__device__ __forceinline__ void quat_step(const T q0[4], T h, const T dw[3], T n[4]) {
  const T hx = mul(h, dw[0]), hy = mul(h, dw[1]), hz = mul(h, dw[2]);
  n[0] = fma_(hx, q0[3], fma_(hy, q0[2], fma_(-hz, q0[1], q0[0])));
  n[1] = fma_(hz, q0[0], fma_(hy, q0[3], fma_(-hx, q0[2], q0[1])));
  n[2] = fma_(hz, q0[3], fma_(-hy, q0[0], fma_(hx, q0[1], q0[2])));
  n[3] = fma_(-hz, q0[2], fma_(-hy, q0[1], fma_(-hx, q0[0], q0[3])));
}

// normalize(q0 (+) (dt/6) * sw), the tick's new attitude
template <typename T>
__device__ __forceinline__ void quat_final(const T q0[4], const T sw[3], const Consts<T>& c,
                                           T q[4]) {
  T n[4];
  quat_step(q0, c.h_sixth, sw, n);
  const T inv_n =
      rsqrt_fast(fma_(n[3], n[3], fma_(n[2], n[2], fma_(n[1], n[1], mul(n[0], n[0])))));
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = mul(n[k], inv_n);
}

// The stage factors: u := u0 (+) f*du, the attitude by h = f/2; the weight
// of the stage's slopes in the sum k1 + 2 k2 + 2 k3 + k4 (added left to
// right) is 2 but for stage 4.
template <typename T>
__device__ __forceinline__ T stage_f(int stage, const Consts<T>& c) {
  return stage == 4 ? c.f_full : c.f_half;
}

template <typename T>
__device__ __forceinline__ T stage_h(int stage, const Consts<T>& c) {
  return stage == 4 ? c.h_full : c.h_half;
}

template <typename T>
__device__ __forceinline__ T add_slope(int stage, T sum, T k) {
  return stage == 4 ? add(sum, k) : fma_(T(2), k, sum);
}

template <typename T>
__device__ __forceinline__ void rk4_tick(T s[kState], const Body<T>& b, const Consts<T>& c) {
  const T q0[4] = {s[0], s[1], s[2], s[3]};
  const T p0[3] = {s[4], s[5], s[6]};
  const T w0[3] = {s[7], s[8], s[9]};
  const T v0[3] = {s[10], s[11], s[12]};
  T n[4], p[3], w[3], v[3], aw[3], av[3];
  T sw[3], sv[3], saw[3], sav[3];

  // stage 1 at u0 (R needs no normalized quaternion)
  accel(q0, p0, v0, b, c, aw, av);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w[k] = w0[k]; v[k] = v0[k];
    sw[k] = w0[k]; sv[k] = v0[k]; saw[k] = aw[k]; sav[k] = av[k];
  }

  // stages 2-4: u := u0 (+) f*du ; du := (w, v, accel(u))
#pragma unroll
  for (int stage = 2; stage <= 4; ++stage) {
    const T f = stage_f(stage, c);
    quat_step(q0, stage_h(stage, c), w, n);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[k] = fma_(f, v[k], p0[k]);
      w[k] = fma_(f, aw[k], w0[k]);
      v[k] = fma_(f, av[k], v0[k]);
    }
    accel(n, p, v, b, c, aw, av);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sw[k] = add_slope(stage, sw[k], w[k]); sv[k] = add_slope(stage, sv[k], v[k]);
      saw[k] = add_slope(stage, saw[k], aw[k]); sav[k] = add_slope(stage, sav[k], av[k]);
    }
  }

  // u := u0 (+) (dt/6) * sum
  quat_final(q0, sw, c, s);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s[4 + k] = fma_(c.f_sixth, sv[k], p0[k]);
    s[7 + k] = fma_(c.f_sixth, saw[k], w0[k]);
    s[10 + k] = fma_(c.f_sixth, sav[k], v0[k]);
  }
}

// One thread a body, blocks of any multiple of 32 threads up to kMaxThreads.
// The bounds ask for one block an SM, so ptxas takes the registers it wants.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
sixdof_rk4_kernel(const T* __restrict__ u, const T* __restrict__ par,
                  T* __restrict__ out, int n, int nticks, Consts<T> c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t stride = static_cast<size_t>(n);
  T s[kState];
#pragma unroll
  for (int k = 0; k < kState; ++k) s[k] = u[k * stride + i];
  const Body<T> b = body(par, stride, i, c);
  for (int t = 0; t < nticks; ++t) rk4_tick(s, b, c);
#pragma unroll
  for (int k = 0; k < kState; ++k) out[k * stride + i] = s[k];
}

template <typename T>
int launch(const void* u, const void* par, void* out, int n, int nticks, double dt,
           double mu, double thrust, double torque, double drag, int threads, void* stream) {
  if (n < 1 || nticks < 0 || threads < kMinThreads || threads > kMaxThreads ||
      threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // stage factors in double, as the host-side Python floats of the
  // reference are, then rounded once to T
  const double f_half = 0.5 * dt;
  const Consts<T> c{T(-mu),     T(thrust), T(torque),   T(-drag),    T(f_half),
                    T(0.5 * f_half), T(dt), T(0.5 * dt), T(dt / 6.0), T(0.5 * dt / 6.0)};
  sixdof_rk4_kernel<T><<<(n + threads - 1) / threads, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(par), static_cast<T*>(out), n, nticks,
      c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C launchers, bound with ctypes.  Each returns a cudaError_t (0 on
// success): cudaErrorInvalidValue for a plan it does not take (threads a
// block not a multiple of 32 in [32, 256]), else cudaGetLastError() after
// the launch.  u/out: (13, n) contiguous, par: (4, n) contiguous, all on
// the current device; stream is a cudaStream_t.
extern "C" int sixdof_rk4_f32(const void* u, const void* par, void* out, int n, int nticks,
                              double dt, double mu, double thrust, double torque,
                              double drag, int threads, void* stream) {
  return launch<float>(u, par, out, n, nticks, dt, mu, thrust, torque, drag, threads, stream);
}

extern "C" int sixdof_rk4_f64(const void* u, const void* par, void* out, int n, int nticks,
                              double dt, double mu, double thrust, double torque,
                              double drag, int threads, void* stream) {
  return launch<double>(u, par, out, n, nticks, dt, mu, thrust, torque, drag, threads, stream);
}
