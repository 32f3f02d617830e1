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
// One sweep per LM iteration. The plain version's iteration takes [H | g]
// from the state's projection, which is the last accepted trial's (or the
// pass's start pose's). So the sweep over the points at a trial pose sums
// both the trial chi-square and [H | g] at that pose (its Cauchy weights
// and Jacobian); the accept test keeps those sums as the next iteration's
// [H | g] (two buffers in shared memory, one index flipped), a rejection
// the old ones. A pass's setup sweep sums [H | g] at its start pose (H's
// diagonal sets lambda) and its chi-square; its last iteration sums the
// chi-square alone (pass 1's setup follows the demotion). A solve is 13
// sweeps (2 setups, 10 trials, the final one) and 13 block reductions,
// where a sweep for [H | g] and one for the trial chi-square per iteration
// took 23 and 25.
//
// Order of the sums. Each reduction over the points runs in the order
// csrc/pnp.cu fixed (ROADMAP H8): thread t accumulates its points in
// order, each warp folds its lanes with an xor butterfly, and the 8 warps'
// partial sums are added in warp order. The normal equations [H | g] are
// summed in float64 and rounded once to float32 (the products jw_i * x_j
// are exact there); the robust chi-square in float32. H's diagonal is the
// diagonal of those sums: pnp.cu's h_diag adds the same products in the
// same pairs. The order depends on M alone, so a stream of an S-stream
// launch gets the bits of its own S = 1 launch, and H equals
// lvt_tpu_torch::pnp_normal_eqs on the same Jacobians bit for bit. H is
// not symmetric to the bit (jw_i = jac_i * w is rounded to float32 before
// its product with jac_j, so H[i][j] and H[j][i] add other products): all
// 42 sums are kept.
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
// The step on one warp. Between two sweeps warp 0 alone adds the warps'
// partial sums (a lane per sum), runs the accept test, and solves the
// damped system (H + lambda I) delta = -g in float32: LU with partial
// pivoting (the first row of largest magnitude), as torch.linalg.solve_ex
// and jnp.linalg.solve factor it, in the order of operations of solve_ex
// on the card, lane i holding row i; then the retraction, lane e computing
// entry e of the trial pose. The other 7 warps wait at one barrier.
// Cholesky would need H + lambda I positive definite, which a
// rank-deficient H with lambda near 1e-12 is not to float32 precision. A
// singular or non-finite system divides by a zero or NaN pivot, so delta is
// not finite, and the accept test rejects the step, as in the plain
// version.
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
// float32 work sets it, about 2.4e-5 ms. This kernel does more: each of
// its 10 sweeps for [H | g] folds all 84 of its products on the FMA pipe,
// with 24 float32 -> float64 conversions a point. One block, one SM, per
// stream does it all; at M = 1024 the sweeps take 45% of its cycles, the
// block reductions 15%, the 10 steps on warp 0 31%, the accept tests 7%
// (scripts/torch_pnp_clocks.py). Measured and dropped: the conversions
// by integer operations (the sweeps 1.8x slower), skipping points of
// weight 0 (a warp's lanes run together: nothing saved), a warp maximum
// for the pivot (slower than the scan). M has no upper bound.

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

// Phase markers: nothing here; scripts/torch_pnp_clocks.py defines them to
// stamp the SM clock (PNP_CLOCK: after a block barrier; PNP_CLOCK_WARP:
// inside warp 0's step) at slot `slot`, the start of a phase of kind
// `kind`
#ifndef PNP_CLOCK
#define PNP_CLOCK(slot, kind)
#define PNP_CLOCK_WARP(slot, kind)
#endif
enum : int {
  CLK_STAGE, CLK_SWEEP, CLK_REDUCE, CLK_SOLVE, CLK_RETRACT, CLK_ACCEPT,
  CLK_END, CLK_BACKSUB
};
// the stamps' slots: the stage, then per pass the setup (sweep, reduction,
// start, and the step: LU, back substitution, retraction) and per
// iteration (trial sweep, reduction, accept, the step), then the final
// sweep, its reduction, the result and the end
constexpr int CLK_PASS = 6 + 6 * N_ITERS;
constexpr int CLK_FINAL = 1 + N_PASSES * CLK_PASS;

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

// ---- the steps on the state (lane 0 of warp 0, or all of warp 0)

// r_wc = to_matrix(q)^T, t_wc = -matvec(r_wc, t)
__device__ void init_pose(float* st) {
  world_to_camera(st + S_T, st + S_Q, st + S_R, st + S_TW);
}

// the pass's damping lambda = tau max(diag H) + 1e-12, nu = 2, and its
// starting chi-square, from the summed [H | g] and chi-square
__device__ void start_pass(float* st, const double* hg, double chi2) {
  float h_max = __double2float_rn(hg[0]);
#pragma unroll
  for (int i = 1; i < NP; ++i) {
    const float h = __double2float_rn(hg[i * NC + i]);
    if (!isnan(h_max) && (h > h_max || isnan(h))) h_max = h;
  }
  st[S_LAM] = __fadd_rn(__fmul_rn(1e-5f, h_max), 1e-12f);
  st[S_NU] = 2.0f;
  st[S_CHI2] = __double2float_rn(chi2);
}

// The LM step from the summed [H | g] on warp 0: the trial pose
// _retract(r_wc, t_wc, delta) and whether delta is finite, into the state.
// (H + lambda I) delta = -g by LU with partial pivoting, lane i < 6
// holding row i of [H + lambda I | -g] in registers (every index a
// constant after unrolling), in the order of operations of the solve
// torch.linalg.solve_ex runs on the card for one 6x6 system (LAPACK's
// getf2 and getrs). At column k every lane scans the column as one thread
// would (a NaN never wins, a NaN pivot candidate keeps its row, ties go
// to the lowest row); the pivot row goes to every lane, which keeps it as
// U's row k, and trades places with row k; the rows below are updated
// with the pivot's reciprocal and fused multiply-adds, a lane each. Then
// every lane runs the back substitution on its copy of U (a division by
// each diagonal entry and fused multiply-adds: a chain no lane could
// shorten). On 400 systems of the plain solve this gave solve_ex's bits
// for every one (the same operations in the same order). Then lane e < 12
// computes entry e of the trial pose, its inputs read before the solve.
__device__ void lm_step(float* st, const double* hg, int lane,
                        [[maybe_unused]] int clk = 0) {
  PNP_CLOCK_WARP(clk, CLK_SOLVE);
  const int e = lane < 12 ? lane : 0;
  const int k3 = e < 9 ? e % 3 : 0;
  const float* in = e < 9 ? st + S_R + k3 : st + S_TW;
  const float x0 = in[0], x1 = in[e < 9 ? 3 : 1], x2 = in[e < 9 ? 6 : 2];
  const float lam = st[S_LAM];
  const int i0 = lane < NP ? lane : 0;
  float row[NP], b;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    row[j] = __double2float_rn(hg[i0 * NC + j]);
    if (j == lane) row[j] = __fadd_rn(row[j], lam);
  }
  b = -__double2float_rn(hg[i0 * NC + NP]);
  float u[NP][NP], d[NP];   // U and the forward-eliminated -g
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    float col[NP];
#pragma unroll
    for (int i = k; i < NP; ++i) col[i] = __shfl_sync(FULL, row[k], i);
    int p = k;
    float best = fabsf(col[k]);
#pragma unroll
    for (int i = k + 1; i < NP; ++i) {
      if (fabsf(col[i]) > best) {
        best = fabsf(col[i]);
        p = i;
      }
    }
    // the pivot row, and rows k and p trading places (the columns left of
    // k are used no more)
#pragma unroll
    for (int j = k; j < NP; ++j) u[k][j] = __shfl_sync(FULL, row[j], p);
    d[k] = __shfl_sync(FULL, b, p);
    const int src = lane == k ? p : (lane == p ? k : lane);
#pragma unroll
    for (int j = k; j < NP; ++j) row[j] = __shfl_sync(FULL, row[j], src);
    b = __shfl_sync(FULL, b, src);
    const float r = __frcp_rn(u[k][k]);   // = __fdiv_rn(1.0f, u[k][k])
    if (lane > k) {
      const float l = __fmul_rn(row[k], r);
#pragma unroll
      for (int j = k + 1; j < NP; ++j) row[j] = __fmaf_rn(-l, u[k][j], row[j]);
      b = __fmaf_rn(-l, d[k], b);
    }
  }
  PNP_CLOCK_WARP(clk + 1, CLK_BACKSUB);
  bool finite = true;
#pragma unroll
  for (int k = NP - 1; k >= 0; --k) {
    d[k] = __fdiv_rn(d[k], u[k][k]);
#pragma unroll
    for (int i = 0; i < k; ++i) d[i] = __fmaf_rn(-u[i][k], d[k], d[i]);
  }
#pragma unroll
  for (int j = 0; j < NP; ++j) finite = finite && isfinite(d[j]);

  PNP_CLOCK_WARP(clk + 2, CLK_RETRACT);
  float dr[9];
  exp_rotation(d[3], d[4], d[5], dr);
  const float v = e < 9 ? 0.0f : (e == 9 ? d[0] : (e == 10 ? d[1] : d[2]));
  const float x = retract_entry(dr, e, x0, x1, x2, v);
  if (lane < 12) st[S_TR_R + lane] = x;   // S_TR_T follows S_TR_R
  if (lane == 0) st[S_TR_OK] = finite ? 1.0f : 0.0f;
  __syncwarp();
}

// accept = chi2_new < chi2 and the step finite (every lane of warp 0 reads
// the same answer; lane 0 then writes): keep the trial pose, lambda / 3,
// nu = 2; else lambda nu, nu 2 nu
__device__ bool accept(float* st, float chi2_new, int lane) {
  const bool ok = chi2_new < st[S_CHI2] && st[S_TR_OK] != 0.0f;
  __syncwarp();
  if (lane == 0) {
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
  __syncwarp();
  return ok;
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

// At the pose (r, t): (if DEMOTE) w_mask *= (e2 <= delta2), then (if
// CHI) the chi-square's terms (float32) and (if HG) [H | g] = sum jw^T
// [jac | r], jw = jac * w (float64)
template <bool DEMOTE, bool HG, bool CHI = true>
__device__ void sweep(const Points& pts, int m, const float* rs,
                      const float* ts, const Cam& c, double (&acc)[NOUT],
                      float& chi) {
  float r[9], t[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) r[i] = rs[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = ts[i];
  if constexpr (HG) {
#pragma unroll
    for (int o = 0; o < NOUT; ++o) acc[o] = 0.0;
  }
  chi = 0.0f;
  for (int p = threadIdx.x; p < m; p += THREADS) {
    float x, y, z, u, v, wm;
    pts.get(p, x, y, z, u, v, wm);
    const Proj pr = project(r, t, x, y, z, u, v, c);
    if constexpr (DEMOTE) {
      wm = __fmul_rn(wm, pr.e2 <= c.th2 ? 1.0f : 0.0f);
      pts.set_w(p, wm);
    }
    if constexpr (HG) {
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
    if constexpr (CHI) chi = __fadd_rn(chi, rho(wm, pr.e2, c));
  }
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

// ---- block reductions in the fixed order

struct Scratch {
  double part[WARPS][NOUT];
  float part_f[WARPS];
  int part_i[WARPS];
};

// Every thread: each warp folds acc[0..42) ([H | g], if HG: `fold` on
// 32 + 8 + 2 values, the full butterfly's pairs) and the chi-square (an
// xor butterfly) over its lanes into sc; then a block barrier.
template <bool HG>
__device__ void publish(double (&acc)[NOUT], float chi, Scratch& sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (HG) {
    fold<0, 32>(acc, lane);
    fold<32, 8>(acc, lane);
    fold<40, 2>(acc, lane);
    sc.part[warp][lane] = acc[0];
    if ((lane & 3) == 0) sc.part[warp][32 + (lane >> 2)] = acc[32];
    if ((lane & 15) == 0) sc.part[warp][40 + (lane >> 4)] = acc[40];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    chi = __fadd_rn(chi, __shfl_xor_sync(FULL, chi, off));
  if (lane == 0) sc.part_f[warp] = chi;
  __syncthreads();
}

// Warp 0, after publish: the warps' sums added in warp order, [H | g]
// into hg[0..42) (if HG; lane l its entries l and 32 + l), and the
// chi-square's total, which every lane returns. These are the sums of
// csrc/pnp.cu's pnp_normal_eqs_kernel and stream_sum_kernel, bit for bit.
template <bool HG>
__device__ float warp_total(const Scratch& sc, double* hg, int lane) {
  if constexpr (HG) {
#pragma unroll
    for (int o = lane; o < NOUT; o += 32) {
      double s = sc.part[0][o];
#pragma unroll
      for (int q = 1; q < WARPS; ++q) s = __dadd_rn(s, sc.part[q][o]);
      hg[o] = s;
    }
  }
  float s = sc.part_f[0];
#pragma unroll
  for (int q = 1; q < WARPS; ++q) s = __fadd_rn(s, sc.part_f[q]);
  __syncwarp();
  return s;
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
  __shared__ double hg[2][NOUT];   // [H | g]: the step's, and the trial's
  __shared__ Scratch sc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long s = blockIdx.x;
  const Points pts{X + s * m * 3, obs + s * m * 2, w_scratch + s * m, sm, cap};
  weights += s * m;
  PNP_CLOCK(0, CLK_STAGE);
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

  double acc[NOUT];
  float chi;
  int cur = 0;   // hg[cur]: the [H | g] of the next step (warp 0's)
  for (int pass = 0; pass < N_PASSES; ++pass) {
    [[maybe_unused]] const int base = 1 + pass * CLK_PASS;
    PNP_CLOCK(base, CLK_SWEEP);
    // at the pass's start pose, the previous pass's outliers gone (raw
    // chi2 > delta2): [H | g] and the chi-square
    if (pass > 0) {
      sweep<true, true>(pts, m, st + S_R, st + S_TW, cam, acc, chi);
    } else {
      sweep<false, true>(pts, m, st + S_R, st + S_TW, cam, acc, chi);
    }
    PNP_CLOCK(base + 1, CLK_REDUCE);
    publish<true>(acc, chi, sc);
    if (warp == 0) {
      cur = 0;
      const float total = warp_total<true>(sc, hg[cur], lane);
      PNP_CLOCK_WARP(base + 2, CLK_ACCEPT);
      if (lane == 0) start_pass(st, hg[cur], total);
      __syncwarp();
      lm_step(st, hg[cur], lane, base + 3);
    }
    __syncthreads();
    for (int it = 0; it < N_ITERS; ++it) {
      [[maybe_unused]] const int at = base + 6 + 6 * it;
      const bool more = it + 1 < N_ITERS;   // a step follows this sweep
      PNP_CLOCK(at, CLK_SWEEP);
      if (more) {
        sweep<false, true>(pts, m, st + S_TR_R, st + S_TR_T, cam, acc, chi);
        PNP_CLOCK(at + 1, CLK_REDUCE);
        publish<true>(acc, chi, sc);
      } else {
        sweep<false, false>(pts, m, st + S_TR_R, st + S_TR_T, cam, acc, chi);
        PNP_CLOCK(at + 1, CLK_REDUCE);
        publish<false>(acc, chi, sc);
      }
      if (warp == 0) {
        const float total = more ? warp_total<true>(sc, hg[1 - cur], lane)
                                 : warp_total<false>(sc, nullptr, lane);
        PNP_CLOCK_WARP(at + 2, CLK_ACCEPT);
        // accepted: the trial's [H | g] is the next step's
        if (accept(st, total, lane) && more) cur = 1 - cur;
        if (more) lm_step(st, hg[cur], lane, at + 3);
      }
      __syncthreads();
    }
  }
  PNP_CLOCK(CLK_FINAL, CLK_SWEEP);
  const int mine = sweep_final(pts, m, st, cam, inlier + s * m);
  PNP_CLOCK(CLK_FINAL + 1, CLK_REDUCE);
  const int n = block_sum_i(mine, sc);
  PNP_CLOCK(CLK_FINAL + 2, CLK_ACCEPT);
  if (threadIdx.x == 0) {
    finish(st);
#pragma unroll
    for (int i = 0; i < 3; ++i) t_out[3 * s + i] = st[S_T + i];
#pragma unroll
    for (int i = 0; i < 4; ++i) q_out[4 * s + i] = st[S_Q + i];
    count[s] = n;
    chi2_out[s] = st[S_CHI2];
  }
  PNP_CLOCK(CLK_FINAL + 3, CLK_END);
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
  __shared__ double hg[NOUT];
  __shared__ Scratch sc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long s = blockIdx.x;
  const Points pts{X + s * m * 3, obs + s * m * 2, w_out + s * m, nullptr, 0};
  w_in += s * m;
  for (int p = threadIdx.x; p < m; p += THREADS) pts.w[p] = w_in[p];
  if (warp == 0) {
    for (int i = lane; i < NSTATE; i += 32) st[i] = state_in[s * NSTATE + i];
    if (kind == K_NORMAL && flag != 0) {
      // start_pass reads H's diagonal where [H | g] has it
      for (int i = lane; i < NP; i += 32) hg[i * NC + i] = tot_a[s * NP + i];
    } else if (kind == K_TRIAL) {
      for (int i = lane; i < NOUT; i += 32) hg[i] = tot_a[s * NOUT + i];
    }
    __syncwarp();
    if (kind == K_SETUP && flag == 0) {
      if (lane == 0) init_pose(st);
    } else if (kind == K_NORMAL && flag != 0) {
      if (lane == 0) start_pass(st, hg, tot_b[s]);
    } else if (kind != K_TRIAL) {
      accept(st, __double2float_rn(tot_b[s]), lane);
    } else {
      lm_step(st, hg, lane);
    }
  }
  __syncthreads();
  double acc[NOUT];
  float chi;
  if (kind == K_SETUP || kind == K_NORMAL) {
    if (kind == K_SETUP && flag != 0) {
      sweep<true, true>(pts, m, st + S_R, st + S_TW, cam, acc, chi);
    } else if (kind == K_SETUP) {
      sweep<false, true>(pts, m, st + S_R, st + S_TW, cam, acc, chi);
    } else {   // the normal equations alone
      sweep<false, true, false>(pts, m, st + S_R, st + S_TW, cam, acc, chi);
    }
    publish<true>(acc, chi, sc);
    if (warp == 0) {
      const float total = warp_total<true>(sc, hg, lane);
      if (kind == K_SETUP) {
        for (int i = lane; i < NP; i += 32)
          part_a[s * NP + i] = hg[i * NC + i];
        if (lane == 0) part_b[s] = static_cast<double>(total);
      } else {
        for (int i = lane; i < NOUT; i += 32) part_a[s * NOUT + i] = hg[i];
        if (lane == 0) part_b[s] = 0.0;
      }
    }
  } else if (kind == K_TRIAL) {
    sweep<false, false>(pts, m, st + S_TR_R, st + S_TR_T, cam, acc, chi);
    publish<false>(acc, chi, sc);
    if (warp == 0) {
      const float total = warp_total<false>(sc, nullptr, lane);
      if (lane == 0) part_b[s] = static_cast<double>(total);
    }
  } else {
    const int n = block_sum_i(sweep_final(pts, m, st, cam, nullptr), sc);
    if (threadIdx.x == 0) {
      finish(st);
      part_b[s] = n;
    }
  }
  __syncthreads();
  if (warp == 0) {
    for (int i = lane; i < NSTATE; i += 32) state_out[s * NSTATE + i] = st[i];
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

// The fused solve's shape: out[0] blocks per stream, out[1] threads per
// block, out[2] points per stream staged in shared memory
extern "C" int lvt_pnp_shape(int* out) {
  out[0] = 1;
  out[1] = THREADS;
  out[2] = CAP;
  return 0;
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
