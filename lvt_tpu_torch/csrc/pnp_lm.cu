// PnP's whole robust Levenberg-Marquardt solve for Hopper: one thread block
// per stream runs lvt_tpu/solver/pnp.py:109-214 (solve_pnp) from the
// initial pose to the refined pose, the inlier mask, the inlier count and
// the robust chi-square, in one launch for all S streams (pnp_solve_kernel).
// It is not a TPU kernel: lvt_tpu runs this solve as XLA ops under jit. In
// PyTorch the same schedule, 2 passes x (a setup + 5 iterations), was about
// 1400 small kernels a frame, each a few microseconds of launch latency
// over a few KB of data; here nothing of it leaves the SM.
//
// What stays where. The pose, the damping lambda, nu and the chi-square
// live in shared memory (the state layout below). Thread t owns the points
// t, t + 256, t + 512, ... for the whole solve: their world positions,
// observations and weights are staged into shared memory once (structure
// of arrays, up to CAP points per stream, 24 bytes each); points beyond
// CAP are read from device memory, and their weights kept in a scratch
// row there. Every per-point quantity of the plain version's state (the
// residual, the camera point, 1/z, the squared error) is recomputed from
// the pose where it is needed: the same operations on the same inputs, so
// the same bits as the plain version's cached copy, without a store.
//
// Order of the sums. Each reduction over the points runs in the order
// csrc/pnp.cu fixed (ROADMAP H8): thread t accumulates its points in
// order, each warp folds its lanes with an xor butterfly, and the 8 warps'
// partial sums are added in warp order. The normal equations [H | g] and
// H's diagonal are summed in float64 and rounded once to float32 (the
// products jw_i * x_j are exact there); the robust chi-square in float32.
// The order depends on M alone, so a stream of an S-stream launch gets the
// bits of its own S = 1 launch, and H equals lvt_tpu_torch::pnp_normal_eqs
// on the same Jacobians bit for bit.
//
// Rounding. The per-point arithmetic (projection, Cauchy weight, Jacobian,
// chi-square term) and the pose algebra use __fmul_rn / __fadd_rn /
// __fdiv_rn in the plain version's order of operations (lvt_tpu_torch/
// solver/pnp.py, geometry/se3.py::matvec, geometry/quaternion.py), and
// divide by reprojection_th2 rather than multiply by its reciprocal
// (device.scalar): NVCC_FLAGS let nvcc contract a multiply and an add
// otherwise. What remains different from the plain version on the card is
// wherever libdevice's sinf, cosf or log1pf round other than torch's
// kernels do, or the 6x6 solve other than below.
//
// The damped solve (H + lambda I) delta = -g runs in float32 on one thread,
// in registers: LU with partial pivoting (the first row of largest
// magnitude), as torch.linalg.solve_ex and jnp.linalg.solve factor it, in
// the order of operations of solve_ex on the card (solve6). Cholesky would
// need H + lambda I positive definite, which a rank-deficient H with
// lambda near 1e-12 is not to float32 precision. A singular or non-finite
// system divides by a zero or NaN pivot, so delta is not finite, and the
// accept test rejects the step, as in the plain version.
//
// The sharded solve (pnp_phase_kernel): a collective cannot run inside a
// kernel, so the same __device__ code also launches split at each
// reduction, the sums over a rank's points written out as float64
// partials for an all-reduce between launches. Per pass: SETUP (H's
// diagonal and the chi-square), then 5 x (NORMAL: [H | g]; TRIAL: the
// step, the retraction and the trial chi-square), then FINAL: 23 launches
// and 25 all-reduces per solve. The accept test of an iteration runs at
// the start of the next launch. On one rank the all-reduces return their
// input, and the phases give the fused kernel's bits.
//
// What bounds it on the card (chip_smoke.py's bound counts the work the
// solve needs): per point 772 float32 operations (the plain version's: a
// projection per setup and per trial) and 564 float64 fused multiply-adds
// (H's upper triangle and g, 54 per normal-equation sweep, and H's
// diagonal twice) at the tensor cores' float64 rate; at M = 1024 the
// float32 work sets it, about 2.4e-5 ms. This kernel does more: each
// normal-equation sweep recomputes the projection and folds all 84 of
// [H | g]'s products on the FMA pipe. One block, one SM, per stream does
// it all: the 10 normal-equation sweeps (float64 products and float32 ->
// float64 conversions, 16 a clock per SM), the 25 serial block reductions
// and the 10 serial 6x6 solves set its time. M has no upper bound.

#include <cuda_runtime.h>

#include "lm_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NP = 6;             // pose parameters
constexpr int NC = 7;             // the 6 Jacobian columns and the residual
constexpr int NOUT = NP * NC;     // [H | g], 42 sums
constexpr int N_PASSES = 2;
constexpr int N_ITERS = 5;
constexpr int CAP = 8192;         // points per stream staged in shared memory
constexpr int SM_FLOATS = 6;      // x, y, z, u, v, w per staged point

// The state of one stream's solve, NSTATE floats (shared memory in the
// fused kernel, a row of device memory between the phases).
enum : int {
  S_T = 0,       // pose t, camera in world [3]: the input, then the result
  S_Q = 3,       // pose q (w, x, y, z) [4]: the input, then the result
  S_R = 7,       // r_wc, world to camera, row major [9]
  S_TW = 16,     // t_wc [3]
  S_LAM = 19,
  S_NU = 20,
  S_CHI2 = 21,
  S_TR_R = 22,   // the trial pose of the current iteration [9]
  S_TR_T = 31,   // [3]
  S_TR_OK = 34,  // 1 if the step was finite, else 0
  NSTATE = 36,
};

// the phases of the sharded solve (lvt_tpu_torch/solver/pnp.py)
enum : int { K_SETUP = 0, K_NORMAL = 1, K_TRIAL = 2, K_FINAL = 3 };

// One stream's points: staged in shared memory (p < cap), else read from
// device memory; w is the working weight row (w_mask) in device memory.
struct Points {
  const float* X;
  const float* obs;
  float* w;
  float* sm;
  int cap;

  __device__ __forceinline__ void get(int p, float& x, float& y, float& z,
                                      float& u, float& v, float& wm) const {
    if (p < cap) {
      x = sm[p];
      y = sm[cap + p];
      z = sm[2 * cap + p];
      u = sm[3 * cap + p];
      v = sm[4 * cap + p];
      wm = sm[5 * cap + p];
    } else {
      x = X[3 * p];
      y = X[3 * p + 1];
      z = X[3 * p + 2];
      u = obs[2 * p];
      v = obs[2 * p + 1];
      wm = w[p];
    }
  }
  __device__ __forceinline__ void set_w(int p, float wm) const {
    if (p < cap) {
      sm[5 * cap + p] = wm;
    } else {
      w[p] = wm;
    }
  }
};

// ---- the plain version's arithmetic (lm_common.cuh has the rest)

// w_mask * delta2 * log1p(e2 / delta2): one term of the robust chi-square
__device__ __forceinline__ float rho(float wm, float e2, const Cam& c) {
  return __fmul_rn(wm, __fmul_rn(c.th2, log1pf(__fdiv_rn(e2, c.th2))));
}

// _jacobians: the two rows [u; v] of d(proj)/d(xi), then the residual
__device__ __forceinline__ void jacobian(const Proj& p, const Cam& c,
                                         float (&ju)[NC], float (&jv)[NC]) {
  const float fxz = __fmul_rn(c.fx, p.iz);
  const float fyz = __fmul_rn(c.fy, p.iz);
  const float fxxz = __fmul_rn(__fmul_rn(fxz, p.px), p.iz);
  const float fyyz = __fmul_rn(__fmul_rn(fyz, p.py), p.iz);
  ju[0] = fxz;
  ju[1] = 0.0f;
  ju[2] = -fxxz;
  ju[3] = -__fmul_rn(fxxz, p.py);
  ju[4] = __fadd_rn(c.fx, __fmul_rn(fxxz, p.px));
  ju[5] = -__fmul_rn(fxz, p.py);
  ju[6] = p.rx;
  jv[0] = 0.0f;
  jv[1] = fyz;
  jv[2] = -fyyz;
  jv[3] = __fsub_rn(-c.fy, __fmul_rn(fyyz, p.py));
  jv[4] = __fmul_rn(fyyz, p.px);
  jv[5] = __fmul_rn(fyz, p.px);
  jv[6] = p.ry;
}

// quaternion.from_matrix: the four Shepperd candidates, the first of the
// largest score, normalised, w >= 0
__device__ void from_matrix(const float* m, float* q) {
  const float m00 = m[0], m01 = m[1], m02 = m[2];
  const float m10 = m[3], m11 = m[4], m12 = m[5];
  const float m20 = m[6], m21 = m[7], m22 = m[8];
  const float tr = __fadd_rn(__fadd_rn(m00, m11), m22);
  const float score[4] = {
      __fadd_rn(1.0f, tr),
      __fsub_rn(__fsub_rn(__fadd_rn(1.0f, m00), m11), m22),
      __fsub_rn(__fadd_rn(__fsub_rn(1.0f, m00), m11), m22),
      __fadd_rn(__fsub_rn(__fsub_rn(1.0f, m00), m11), m22)};
  // torch.argmax: NaN counts as the largest, the first index on ties
  int best = 0;
  float top = score[0];
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    if (!isnan(top) && (score[i] > top || isnan(score[i]))) {
      best = i;
      top = score[i];
    }
  }
  const float s21 = __fsub_rn(m21, m12), s02 = __fsub_rn(m02, m20);
  const float s10 = __fsub_rn(m10, m01), a01 = __fadd_rn(m01, m10);
  const float a02 = __fadd_rn(m02, m20), a12 = __fadd_rn(m12, m21);
  if (best == 0) {
    q[0] = score[0]; q[1] = s21; q[2] = s02; q[3] = s10;
  } else if (best == 1) {
    q[0] = s21; q[1] = score[1]; q[2] = a01; q[3] = a02;
  } else if (best == 2) {
    q[0] = s02; q[1] = a01; q[2] = score[2]; q[3] = a12;
  } else {
    q[0] = s10; q[1] = a02; q[2] = a12; q[3] = score[3];
  }
  normalize(q);
  if (q[0] < 0.0f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = -q[i];
  }
}

// ---- the steps one thread takes on the state

// r_wc = to_matrix(q)^T, t_wc = -matvec(r_wc, t)
__device__ void init_pose(float* st) {
  world_to_camera(st + S_T, st + S_Q, st + S_R, st + S_TW);
}

// the pass's damping lambda = tau max(diag H) + 1e-12, nu = 2, and its
// starting chi-square, from the summed diagonal and chi-square
__device__ void start_pass(float* st, const double* h_diag, double chi2) {
  float h_max = __double2float_rn(h_diag[0]);
#pragma unroll
  for (int i = 1; i < NP; ++i) {
    const float h = __double2float_rn(h_diag[i]);
    if (!isnan(h_max) && (h > h_max || isnan(h))) h_max = h;
  }
  st[S_LAM] = __fadd_rn(__fmul_rn(1e-5f, h_max), 1e-12f);
  st[S_NU] = 2.0f;
  st[S_CHI2] = __double2float_rn(chi2);
}

// (H + lambda I) delta = -g by LU with partial pivoting, in registers
// (every index a constant after unrolling), in the order of operations of
// the solve torch.linalg.solve_ex runs on the card for one 6x6 system
// (LAPACK's getf2 and getrs): at column k the first row of largest
// magnitude is swapped in, the column below the pivot scaled by the
// pivot's reciprocal, the rest updated with fused multiply-adds; then the
// triangular solves with fused multiply-adds and a division by each
// diagonal entry. On 400 systems of the plain solve this gave
// solve_ex's bits for every one (the same operations in the same order).
__device__ __forceinline__ void solve6(float (&a)[NP][NP], float (&b)[NP]) {
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    int p = k;
    float best = fabsf(a[k][k]);
#pragma unroll
    for (int i = k + 1; i < NP; ++i) {
      if (fabsf(a[i][k]) > best) {
        best = fabsf(a[i][k]);
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < NP; ++i) {
      if (i == p) {
#pragma unroll
        for (int j = k; j < NP; ++j) {
          const float tmp = a[k][j];
          a[k][j] = a[i][j];
          a[i][j] = tmp;
        }
        const float tmp = b[k];
        b[k] = b[i];
        b[i] = tmp;
      }
    }
    const float r = __fdiv_rn(1.0f, a[k][k]);
#pragma unroll
    for (int i = k + 1; i < NP; ++i) {
      const float l = __fmul_rn(a[i][k], r);
#pragma unroll
      for (int j = k + 1; j < NP; ++j)
        a[i][j] = __fmaf_rn(-l, a[k][j], a[i][j]);
      b[i] = __fmaf_rn(-l, b[k], b[i]);
    }
  }
#pragma unroll
  for (int k = NP - 1; k >= 0; --k) {
    b[k] = __fdiv_rn(b[k], a[k][k]);
#pragma unroll
    for (int i = 0; i < k; ++i) b[i] = __fmaf_rn(-a[i][k], b[k], b[i]);
  }
}

// the LM step from the summed [H | g]: the trial pose _retract(r_wc, t_wc,
// delta) and whether delta is finite
__device__ void trial(float* st, const double* hg) {
  float a[NP][NP], d[NP];
  const float lam = st[S_LAM];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
#pragma unroll
    for (int j = 0; j < NP; ++j) a[i][j] = __double2float_rn(hg[i * NC + j]);
    a[i][i] = __fadd_rn(a[i][i], lam);
    d[i] = -__double2float_rn(hg[i * NC + NP]);
  }
  solve6(a, d);
  bool finite = true;
#pragma unroll
  for (int i = 0; i < NP; ++i) finite = finite && isfinite(d[i]);

  retract(st + S_R, st + S_TW, d, st + S_TR_R, st + S_TR_T);
  st[S_TR_OK] = finite ? 1.0f : 0.0f;
}

// accept = chi2_new < chi2 and the step finite: keep the trial pose,
// lambda / 3, nu = 2; else lambda nu, nu 2 nu
__device__ void accept(float* st, double chi2_new_sum) {
  const float chi2_new = __double2float_rn(chi2_new_sum);
  const bool ok = chi2_new < st[S_CHI2] && st[S_TR_OK] != 0.0f;
  if (ok) {
#pragma unroll
    for (int i = 0; i < 9; ++i) st[S_R + i] = st[S_TR_R + i];
#pragma unroll
    for (int i = 0; i < 3; ++i) st[S_TW + i] = st[S_TR_T + i];
    st[S_LAM] = __fdiv_rn(st[S_LAM], 3.0f);
    st[S_NU] = 2.0f;
    st[S_CHI2] = chi2_new;
  } else {
    st[S_LAM] = __fmul_rn(st[S_LAM], st[S_NU]);
    st[S_NU] = __fmul_rn(st[S_NU], 2.0f);
  }
}

// the result: t = -matvec(r_cw, t_wc), q = from_matrix(r_cw), r_cw = r_wc^T
__device__ void finish(float* st) {
  float r_cw[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r_cw[3 * i + j] = st[S_R + 3 * j + i];
  const float* tw = st + S_TW;
#pragma unroll
  for (int i = 0; i < 3; ++i) st[S_T + i] = -mv(r_cw, i, tw[0], tw[1], tw[2]);
  from_matrix(r_cw, st + S_Q);
}

// ---- sweeps over a thread's points (every thread of the block)

// At the pose: (if `demote`) w_mask *= (e2 <= delta2), then H's diagonal
// (float64, 6 sums) and the chi-square's terms (float32)
__device__ void sweep_setup(const Points& pts, int m, const float* st,
                            const Cam& c, bool demote, double (&acc)[NP],
                            float& chi) {
  float r[9], t[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) r[i] = st[S_R + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = st[S_TW + i];
#pragma unroll
  for (int i = 0; i < NP; ++i) acc[i] = 0.0;
  chi = 0.0f;
  for (int p = threadIdx.x; p < m; p += THREADS) {
    float x, y, z, u, v, wm;
    pts.get(p, x, y, z, u, v, wm);
    const Proj pr = project(r, t, x, y, z, u, v, c);
    if (demote) {
      wm = __fmul_rn(wm, pr.e2 <= c.th2 ? 1.0f : 0.0f);
      pts.set_w(p, wm);
    }
    const float w = cauchy(wm, pr.e2, c);
    float ju[NC], jv[NC];
    jacobian(pr, c, ju, jv);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const double a = __fmul_rn(ju[i], w);
      acc[i] = __fma_rn(a, static_cast<double>(ju[i]), acc[i]);
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const double a = __fmul_rn(jv[i], w);
      acc[i] = __fma_rn(a, static_cast<double>(jv[i]), acc[i]);
    }
    chi = __fadd_rn(chi, rho(wm, pr.e2, c));
  }
}

// At the pose: [H | g] = sum jw^T [jac | r], jw = jac * w (float64)
__device__ void sweep_normal(const Points& pts, int m, const float* st,
                             const Cam& c, double (&acc)[NOUT]) {
  float r[9], t[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) r[i] = st[S_R + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = st[S_TW + i];
#pragma unroll
  for (int o = 0; o < NOUT; ++o) acc[o] = 0.0;
  for (int p = threadIdx.x; p < m; p += THREADS) {
    float x, y, z, u, v, wm;
    pts.get(p, x, y, z, u, v, wm);
    const Proj pr = project(r, t, x, y, z, u, v, c);
    const float w = cauchy(wm, pr.e2, c);
    float rows[2][NC];
    jacobian(pr, c, rows[0], rows[1]);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const double a = __fmul_rn(rows[k][i], w);
#pragma unroll
        for (int j = 0; j < NC; ++j)
          acc[i * NC + j] =
              __fma_rn(a, static_cast<double>(rows[k][j]), acc[i * NC + j]);
      }
    }
  }
}

// At the trial pose: the chi-square's terms (float32)
__device__ float sweep_trial(const Points& pts, int m, const float* st,
                             const Cam& c) {
  float r[9], t[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) r[i] = st[S_TR_R + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = st[S_TR_T + i];
  float chi = 0.0f;
  for (int p = threadIdx.x; p < m; p += THREADS) {
    float x, y, z, u, v, wm;
    pts.get(p, x, y, z, u, v, wm);
    const Proj pr = project(r, t, x, y, z, u, v, c);
    chi = __fadd_rn(chi, rho(wm, pr.e2, c));
  }
  return chi;
}

// At the pose: the last demotion, the inlier mask (w_mask > 0) if `inlier`
// is given, and this thread's inlier count
__device__ int sweep_final(const Points& pts, int m, const float* st,
                           const Cam& c, unsigned char* inlier) {
  float r[9], t[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) r[i] = st[S_R + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = st[S_TW + i];
  int n = 0;
  for (int p = threadIdx.x; p < m; p += THREADS) {
    float x, y, z, u, v, wm;
    pts.get(p, x, y, z, u, v, wm);
    const Proj pr = project(r, t, x, y, z, u, v, c);
    wm = __fmul_rn(wm, pr.e2 <= c.th2 ? 1.0f : 0.0f);
    pts.set_w(p, wm);
    n += wm > 0.0f;
    if (inlier != nullptr) inlier[p] = wm > 0.0f;
  }
  return n;
}

// ---- block reductions in the fixed order; every thread calls them

struct Scratch {
  double part[WARPS][NOUT];
  float part_f[WARPS];
  int part_i[WARPS];
};

// Each warp folds acc[0..N) over its lanes (N = 6: H's diagonal, a full
// butterfly per value; N = 42: [H | g], `fold` on 32 + 8 + 2 values);
// thread o < N then adds the warps' sums in warp order into out[o]
// (shared or device memory). The sums are those of csrc/pnp.cu's
// pnp_normal_eqs_kernel, bit for bit.
template <int N>
__device__ void block_sum(double (&acc)[N], Scratch& sc, double* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (N == NOUT) {
    fold<0, 32>(acc, lane);
    fold<32, 8>(acc, lane);
    fold<40, 2>(acc, lane);
    sc.part[warp][lane] = acc[0];
    if ((lane & 3) == 0) sc.part[warp][32 + (lane >> 2)] = acc[32];
    if ((lane & 15) == 0) sc.part[warp][40 + (lane >> 4)] = acc[40];
  } else {
#pragma unroll
    for (int o = 0; o < N; ++o) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[o] = __dadd_rn(acc[o], __shfl_xor_sync(FULL, acc[o], off));
    }
    if (lane == 0) {
#pragma unroll
      for (int o = 0; o < N; ++o) sc.part[warp][o] = acc[o];
    }
  }
  __syncthreads();
  if (threadIdx.x < N) {
    double s = sc.part[0][threadIdx.x];
#pragma unroll
    for (int q = 1; q < WARPS; ++q) s = __dadd_rn(s, sc.part[q][threadIdx.x]);
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// The float32 sum, as csrc/pnp.cu's stream_sum_kernel; widened exactly
// into *out by thread 0.
__device__ void block_sum_f(float acc, Scratch& sc, double* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(FULL, acc, off));
  if (lane == 0) sc.part_f[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = sc.part_f[0];
#pragma unroll
    for (int q = 1; q < WARPS; ++q) s = __fadd_rn(s, sc.part_f[q]);
    *out = static_cast<double>(s);
  }
  __syncthreads();
}

__device__ int block_sum_i(int acc, Scratch& sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (lane == 0) sc.part_i[warp] = acc;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int q = 0; q < WARPS; ++q) s += sc.part_i[q];
  return s;
}

// ---- the fused solve: one block per stream, one launch for all streams

__global__ void __launch_bounds__(THREADS, 1) pnp_solve_kernel(
    const float* __restrict__ t0, const float* __restrict__ q0,
    const float* __restrict__ X, const float* __restrict__ obs,
    const float* __restrict__ weights, int m, int cap, Cam cam,
    float* __restrict__ w_scratch, float* __restrict__ t_out,
    float* __restrict__ q_out, unsigned char* __restrict__ inlier,
    long long* __restrict__ count, float* __restrict__ chi2_out) {
  extern __shared__ float sm[];
  __shared__ float st[NSTATE];
  __shared__ double tot[NOUT + 1];   // the last sums; tot[NOUT]: a chi-square
  __shared__ Scratch sc;
  const long long s = blockIdx.x;
  const Points pts{X + s * m * 3, obs + s * m * 2, w_scratch + s * m, sm, cap};
  weights += s * m;
  for (int p = threadIdx.x; p < m; p += THREADS) {
    if (p < cap) {
      sm[p] = pts.X[3 * p];
      sm[cap + p] = pts.X[3 * p + 1];
      sm[2 * cap + p] = pts.X[3 * p + 2];
      sm[3 * cap + p] = pts.obs[2 * p];
      sm[4 * cap + p] = pts.obs[2 * p + 1];
      sm[5 * cap + p] = weights[p];
    } else {
      pts.w[p] = weights[p];
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) st[S_T + i] = t0[3 * s + i];
#pragma unroll
    for (int i = 0; i < 4; ++i) st[S_Q + i] = q0[4 * s + i];
    init_pose(st);
  }
  __syncthreads();

  for (int pass = 0; pass < N_PASSES; ++pass) {
    {
      double acc[NP];
      float chi;
      // the previous pass's outliers leave (raw chi2 > delta2)
      sweep_setup(pts, m, st, cam, pass > 0, acc, chi);
      block_sum<NP>(acc, sc, tot);
      block_sum_f(chi, sc, tot + NOUT);
    }
    if (threadIdx.x == 0) start_pass(st, tot, tot[NOUT]);
    __syncthreads();
    for (int it = 0; it < N_ITERS; ++it) {
      {
        double acc[NOUT];
        sweep_normal(pts, m, st, cam, acc);
        block_sum<NOUT>(acc, sc, tot);
      }
      if (threadIdx.x == 0) trial(st, tot);
      __syncthreads();
      block_sum_f(sweep_trial(pts, m, st, cam), sc, tot + NOUT);
      if (threadIdx.x == 0) accept(st, tot[NOUT]);
      __syncthreads();
    }
  }
  const int n = block_sum_i(sweep_final(pts, m, st, cam, inlier + s * m), sc);
  if (threadIdx.x == 0) {
    finish(st);
#pragma unroll
    for (int i = 0; i < 3; ++i) t_out[3 * s + i] = st[S_T + i];
#pragma unroll
    for (int i = 0; i < 4; ++i) q_out[4 * s + i] = st[S_Q + i];
    count[s] = n;
    chi2_out[s] = st[S_CHI2];
  }
}

// ---- one phase of the sharded solve: one block per stream

// kind K_SETUP (flag: the pass): pass 0 takes the pose (t, q) from the
// state; pass 1 first accepts the last trial (tot_b: its chi-square summed)
// and demotes. Out: part_a [6] H's diagonal, part_b the chi-square.
// K_NORMAL (flag: the pass's first iteration): starts the pass (tot_a: the
// diagonal, tot_b: the chi-square) or accepts the last trial (tot_b). Out:
// part_a [42] = [H | g]. K_TRIAL: the step from tot_a = [H | g]. Out:
// part_b the trial chi-square. K_FINAL: accepts (tot_b), demotes, writes
// the pose (t, q) into the state. Out: part_b the inlier count.
__global__ void __launch_bounds__(THREADS, 1) pnp_phase_kernel(
    int kind, int flag, const float* __restrict__ state_in,
    float* __restrict__ state_out, const float* __restrict__ w_in,
    float* __restrict__ w_out, const float* __restrict__ X,
    const float* __restrict__ obs, int m, Cam cam,
    const double* __restrict__ tot_a, const double* __restrict__ tot_b,
    double* __restrict__ part_a, double* __restrict__ part_b) {
  __shared__ float st[NSTATE];
  __shared__ Scratch sc;
  const long long s = blockIdx.x;
  const Points pts{X + s * m * 3, obs + s * m * 2, w_out + s * m, nullptr, 0};
  w_in += s * m;
  for (int p = threadIdx.x; p < m; p += THREADS) pts.w[p] = w_in[p];
  if (threadIdx.x == 0) {
    for (int i = 0; i < NSTATE; ++i) st[i] = state_in[s * NSTATE + i];
    if (kind == K_SETUP && flag == 0) {
      init_pose(st);
    } else if (kind == K_NORMAL && flag != 0) {
      start_pass(st, tot_a + s * NP, tot_b[s]);
    } else if (kind != K_TRIAL) {
      accept(st, tot_b[s]);
    } else {
      trial(st, tot_a + s * NOUT);
    }
  }
  __syncthreads();
  if (kind == K_SETUP) {
    double acc[NP];
    float chi;
    sweep_setup(pts, m, st, cam, flag != 0, acc, chi);
    block_sum<NP>(acc, sc, part_a + s * NP);
    block_sum_f(chi, sc, part_b + s);
  } else if (kind == K_NORMAL) {
    double acc[NOUT];
    sweep_normal(pts, m, st, cam, acc);
    block_sum<NOUT>(acc, sc, part_a + s * NOUT);
    if (threadIdx.x == 0) part_b[s] = 0.0;
  } else if (kind == K_TRIAL) {
    block_sum_f(sweep_trial(pts, m, st, cam), sc, part_b + s);
  } else {
    const int n = block_sum_i(sweep_final(pts, m, st, cam, nullptr), sc);
    if (threadIdx.x == 0) {
      finish(st);
      part_b[s] = n;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < NSTATE; ++i) state_out[s * NSTATE + i] = st[i];
  }
}

}  // namespace

// Inputs t [S, 3], q [S, 4] (the initial pose, camera in world), points
// [S, M, 3], obs [S, M, 2], weights [S, M] float32; scratch [S, M] float32
// (the weights of points beyond the shared-memory stage); outputs t, q,
// inlier [S, M] bool, count [S] int64, chi2 [S] float32. One block per
// stream.
extern "C" int lvt_pnp_solve(const float* t0, const float* q0, const float* X,
                             const float* obs, const float* weights,
                             int n_streams, int m, float fx, float fy,
                             float cx, float cy, float th2, float* scratch,
                             float* t_out, float* q_out, void* inlier,
                             long long* count, float* chi2, void* stream) {
  // Above 48 KB of dynamic shared memory a launch needs the kernel's
  // limit raised, and the attribute holds for the current device only: it
  // is set before every launch (a host-side call, allowed during stream
  // capture), always to the same value, so that any device and any thread
  // launching finds it set.
  const cudaError_t err = cudaFuncSetAttribute(
      pnp_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      CAP * SM_FLOATS * static_cast<int>(sizeof(float)));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_streams > 0) {
    const int cap = m < CAP ? m : CAP;
    const size_t smem = static_cast<size_t>(cap) * SM_FLOATS * sizeof(float);
    pnp_solve_kernel<<<n_streams, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        t0, q0, X, obs, weights, m, cap, Cam{fx, fy, cx, cy, th2}, scratch,
        t_out, q_out, static_cast<unsigned char*>(inlier), count, chi2);
  }
  return static_cast<int>(cudaGetLastError());
}

// One phase (`kind`, `flag`: see pnp_phase_kernel) of S streams: state
// [S, 36] and w [S, M] float32 in, new ones out; points, obs as above;
// tot_a [S, 6 or 42], tot_b [S] float64 (the summed partials the phase
// reads, or null); part_a [S, 6 or 42], part_b [S] float64 out.
extern "C" int lvt_pnp_phase(int kind, int flag, const float* state_in,
                             float* state_out, const float* w_in,
                             float* w_out, const float* X, const float* obs,
                             int n_streams, int m, float fx, float fy,
                             float cx, float cy, float th2,
                             const double* tot_a, const double* tot_b,
                             double* part_a, double* part_b, void* stream) {
  if (n_streams > 0) {
    pnp_phase_kernel<<<n_streams, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        kind, flag, state_in, state_out, w_in, w_out, X, obs, m,
        Cam{fx, fy, cx, cy, th2}, tot_a, tot_b, part_a, part_b);
  }
  return static_cast<int>(cudaGetLastError());
}
