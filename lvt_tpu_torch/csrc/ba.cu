// Local BA's whole body for Hopper: one thread block per stream computes,
// in one launch for all S streams (ba_refine_kernel), what
// lvt_tpu_torch/core/step.py::_refine_structure computes without a group:
// the chi-square gate of the window's observations (solver/bundle.py::
// chi2_gate_weights), the points that take part (>= 2 left observations
// and >= 1 stereo pair), the predicated Levenberg-Marquardt iterations of
// bundle.py::refine_window (the Schur complement onto the cameras, the
// gauge fix, the reduced solve, the back-substitution for the points, the
// retraction and the accept test), then the trust region and the
// improvement test of each refined point (two bundle.py::
// weighted_point_e2 sums) and the select. It is not a TPU kernel: lvt_tpu
// runs this as XLA ops under jit (lvt_tpu/solver/bundle.py:93-378, called
// from the lax.cond of lvt_tpu/core/step.py:269-318). In PyTorch the same
// body was about 3200 small kernels, copies and fills once per BA frame.
//
// What stays where. The poses (world to camera, current, original and
// trial), lambda, nu, the chi-square and the reduced camera system live in
// shared memory. Everything per point lives in a scratch row of device
// memory per stream (structure of arrays, so a warp reads 32 points in one
// transaction), which at M = 1024 and F = 4 is 0.7 MB and stays in L2:
// the current and trial positions, the gated weights, the old fit e2, the
// mask `use`, and per iteration h_cp [F, 6, 3], h_cp h_pp^-1 [F, 6, 3],
// g_p [3] and h_pp^-1 [3, 3].
//
// One iteration. (1) Thread-per-point: every observation block (left, then
// right camera) and pose gives the residual, the Cauchy weight and the
// Jacobians; per point h_cp, h_pp and g_p, h_pp^-1 (the adjugate, as
// _inv33) and h_cp h_pp^-1. (2) Warp-per-sum: the sums over the points,
// each warp one task with its lanes striding over the points: S's 6x6
// block (f, g) (Schur term), h_cc's and g_c's block (camera b, pose f)
// (its Jacobians recomputed from the point: the same operations, so the
// same bits), or g_red's Schur term of pose f. The fixed pose's rows and
// columns become the identity (the gauge fix), so no task computes them.
// (3) The reduced system assembled in float32 as the plain version does,
// widened, and solved by one warp: LU with partial pivoting, then the two
// triangular solves. (4) Thread-per-point: dp = -h_pp^-1 (g_p + h_cp^T dc),
// the trial positions; the poses retracted. (5) The robust chi-square at
// the trial state, and the accept test on thread 0: a rejected step keeps
// the state and only adapts lambda; a non-finite dc or dp is rejected.
//
// Rounding. The per-point float32 arithmetic is the plain version's
// operation by operation (lm_common.cuh: __fmul_rn and friends, no fused
// multiply-add, the IEEE divisions, log1pf, sinf and cosf as torch's
// kernels call them). Every contraction the plain version runs through
// bundle.py::_einsum64 / _wide / _sum64 is a float64 sum of products of
// float32 numbers (exact in float64), rounded once to float32; here the
// same products are summed in float64 in a fixed order and rounded once
// (an exact product added is a fused multiply-add of its two factors),
// which gives the same float32 except where the exact sum lies within
// ~1e-16 relative of a float32 rounding boundary. The float64 solve
// follows the order of operations of the one the plain version runs on
// the card (cuBLAS's batched LU and triangular solves; see lu_solve): a
// window of few points leaves the reduced system ill-conditioned enough
// that another order moves dc by a float32 ulp. Every order here depends
// on M and F alone, so a stream of an S-stream launch gets the bits of its
// own S = 1 launch.
//
// Sizes: any M; F up to MAX_F poses (the wrapper refuses more), the first
// pose fixed.

#include <cuda_runtime.h>

#include "lm_common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_F = 8;            // window poses per stream
constexpr int MAX_N = 6 * MAX_F;    // the reduced camera system's size
constexpr int NB = 2;               // observation blocks: left, right camera
constexpr int CP = 18;              // a point's 6 x 3 block of h_cp per pose

// ba_refine_kernel's launches on this device since the library was loaded:
// counted by the kernel itself, so that a CUDA graph's replays count too (a
// kernel trace can lose the records of an IF node's body)
__device__ unsigned long long g_launches;

// one stream's inputs
struct Window {
  const float* t;      // [F, 3] camera-in-world poses
  const float* q;      // [F, 4]
  const float* pos;    // [M, 3] map positions
  const float* obs[NB];  // [F, M, 2] left, right pixel observations
  const float* w[NB];    // [F, M] their weights (0/1)
};

// one stream's scratch row, float32 arrays of M (structure of arrays)
struct Scratch {
  float* pts[2];   // [3][M] the current positions and the trial ones
  float* wg;       // [NB][F][M] the gated weights, times `use`
  float* e2_old;   // [M] the fit at the original state (weighted_point_e2)
  float* use;      // [M]
  float* hcp;      // [F][6][3][M] h_cp
  float* a;        // [F][6][3][M] h_cp h_pp^-1
  float* gp;       // [3][M]
  float* hinv;     // [9][M] h_pp^-1

  __device__ Scratch(float* base, int f_dim, int m) {
    pts[0] = base;
    pts[1] = pts[0] + 3 * m;
    wg = pts[1] + 3 * m;
    e2_old = wg + NB * f_dim * m;
    use = e2_old + m;
    hcp = use + m;
    a = hcp + f_dim * CP * m;
    gp = a + f_dim * CP * m;
    hinv = gp + 3 * m;
  }
};

// floats of Scratch per point
__host__ __device__ constexpr int scratch_per_point(int f_dim) {
  return 3 + 3 + NB * f_dim + 1 + 1 + 2 * f_dim * CP + 3 + 9;
}

// shared state of a stream's block
struct Shared {
  float r0[MAX_F][9], t0[MAX_F][3];    // the original poses, world to camera
  float r[MAX_F][9], t[MAX_F][3];      // the current ones
  float rt[MAX_F][9], tt[MAX_F][3];    // the trial ones
  float tn[3];                         // the newest pose's position
  float sc[MAX_F * MAX_F * 36];        // S's Schur sums, rounded
  float hcc[NB][MAX_F][36], gc[NB][MAX_F][6], gpart[MAX_F][6];
  double a[MAX_N][MAX_N];              // the reduced system, then its LU
  double b[MAX_N];                     // its right-hand side, then dc
  float dc[MAX_N];
  double part[WARPS][4];
  int part_i[WARPS];
  double sums[4];
  float lam, nu, chi2, gate;
  int cur;       // which of Scratch::pts holds the current positions
  int bad;       // a non-finite dc or dp
};

// ---- one observation, operation by operation

struct Obs {
  float jc[2][6];   // d(pixel)/d(pose), rows u, v
  float jp[2][3];   // d(pixel)/d(point)
  float rx, ry, e2, wr;
};

// The residual of point (x, y, z) against the observation (u, v) of weight
// w in the camera (r, t) of block b (the right camera sits at x_off in the
// left frame), its Cauchy weight wr = w / (1 + e2 / delta2), and the
// Jacobians of bundle.py's block_jacobians: jc = dpi [I | -[p_l]x] and
// jp = dpi r, each entry a float64 sum of float32 products, rounded once
// (_einsum64).
__device__ __forceinline__ Obs observe(const float* r, const float* t,
                                       float x, float y, float z, float u,
                                       float v, float w, int b, float x_off,
                                       const Cam& c) {
  float lx, ly, lz;
  camera_point(r, t, x, y, z, lx, ly, lz);
  const Proj p = project_cam(b == 0 ? lx : __fadd_rn(lx, x_off), ly, lz, u,
                             v, c);
  Obs o;
  o.rx = p.rx;
  o.ry = p.ry;
  o.e2 = p.e2;
  o.wr = cauchy(w, p.e2, c);
  const float fxz = __fmul_rn(c.fx, p.iz);
  const float fyz = __fmul_rn(c.fy, p.iz);
  const float dpi[2][3] = {
      {fxz, 0.0f, __fmul_rn(__fmul_rn(-fxz, p.px), p.iz)},
      {0.0f, fyz, __fmul_rn(__fmul_rn(-fyz, p.py), p.iz)}};
  // dp/dxi = [I | -[p_l]x], -[p_l]x = -skew(p_l)
  const float dxi[3][6] = {{1.0f, 0.0f, 0.0f, -0.0f, lz, -ly},
                           {0.0f, 1.0f, 0.0f, -lz, -0.0f, lx},
                           {0.0f, 0.0f, 1.0f, ly, -lx, -0.0f}};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      double s = __dmul_rn(dpi[k][0], dxi[0][i]);
      s = __fma_rn(dpi[k][1], dxi[1][i], s);
      o.jc[k][i] = __double2float_rn(__fma_rn(dpi[k][2], dxi[2][i], s));
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      double s = __dmul_rn(dpi[k][0], r[i]);
      s = __fma_rn(dpi[k][1], r[3 + i], s);
      o.jp[k][i] = __double2float_rn(__fma_rn(dpi[k][2], r[6 + i], s));
    }
  }
  return o;
}

// one term of the robust chi-square: w_b * delta2 * log1p(e2 / delta2)
__device__ __forceinline__ float rho(float w, float e2, const Cam& c) {
  return __fmul_rn(__fmul_rn(w, c.th2), log1pf(__fdiv_rn(e2, c.th2)));
}

// sqrt((v0^2 + v1^2) + v2^2), step.py::_norm3
__device__ __forceinline__ float norm3(float a, float b, float c) {
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                              __fmul_rn(c, c)));
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// ---- block reductions; every thread calls them

// The N float64 values of every thread summed over the block (each warp by
// an xor butterfly, then the warps in order by thread o), into sh.sums.
template <int N>
__device__ void block_sum(double (&v)[N], Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 0; o < N; ++o) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[o] = __dadd_rn(v[o], __shfl_xor_sync(FULL, v[o], off));
    if (lane == 0) sh.part[warp][o] = v[o];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    double s = sh.part[0][threadIdx.x];
#pragma unroll
    for (int q = 1; q < WARPS; ++q) s = __dadd_rn(s, sh.part[q][threadIdx.x]);
    sh.sums[threadIdx.x] = s;
  }
  __syncthreads();
}

__device__ int block_count(int v, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  if (lane == 0) sh.part_i[warp] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int q = 0; q < WARPS; ++q) s += sh.part_i[q];
  __syncthreads();
  return s;
}

// A warp's N float64 partial sums over its lanes (xor butterfly): every
// lane ends with the totals.
template <int N>
__device__ __forceinline__ void warp_sum(double (&v)[N]) {
#pragma unroll
  for (int o = 0; o < N; ++o) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[o] = __dadd_rn(v[o], __shfl_xor_sync(FULL, v[o], off));
  }
}

// ---- the gate (chi2_gate_weights) and the points that take part

// Sweep of the window at the original state: the float64 sums of the
// weights and of weight x e2 of both blocks, with each weight w_b cut to
// w_b * (e2 <= cut) if `trim`, into sh.sums: [sum w_0, sum w_1, sum w_0 e2,
// sum w_1 e2].
__device__ void gate_moments(const Window& in, int f_dim, int m, float x_off,
                             const Cam& c, bool trim, float cut, Shared& sh) {
  double v[4] = {0.0, 0.0, 0.0, 0.0};
  for (int p = threadIdx.x; p < m; p += THREADS) {
    const float x = in.pos[3 * p], y = in.pos[3 * p + 1],
                z = in.pos[3 * p + 2];
    for (int b = 0; b < NB; ++b) {
      for (int f = 0; f < f_dim; ++f) {
        const long long o = static_cast<long long>(f) * m + p;
        float lx, ly, lz;
        camera_point(sh.r0[f], sh.t0[f], x, y, z, lx, ly, lz);
        const Proj pr = project_cam(b == 0 ? lx : __fadd_rn(lx, x_off), ly,
                                    lz, in.obs[b][2 * o], in.obs[b][2 * o + 1],
                                    c);
        const float w = trim ? __fmul_rn(in.w[b][o], pr.e2 <= cut ? 1.0f : 0.0f)
                             : in.w[b][o];
        v[b] = __dadd_rn(v[b], static_cast<double>(w));
        v[2 + b] = __dadd_rn(v[2 + b],
                             static_cast<double>(__fmul_rn(w, pr.e2)));
      }
    }
  }
  block_sum<4>(v, sh);
}

// mean_e2: (sum w e2) / clamp(sum w, min=1), the sums rounded once each
__device__ float mean_e2(const Shared& sh) {
  const float n = clamp_min(
      __fadd_rn(__fadd_rn(0.0f, __double2float_rn(sh.sums[0])),
                __double2float_rn(sh.sums[1])),
      1.0f);
  const float e = __fadd_rn(__fadd_rn(0.0f, __double2float_rn(sh.sums[2])),
                            __double2float_rn(sh.sums[3]));
  return __fdiv_rn(e, n);
}

// ---- the reduced camera solve

// The n x n system in sh.a, sh.b solved by one warp, in the order of
// operations of bundle.py::_solve64 on the card (cuBLAS's batched LU and
// its triangular solves; scripts/torch_ba_lu_probe.py matched each step on
// every system it recorded, bit for bit in float64): the LU with partial
// pivoting as LAPACK's getf2 (at column k the first row of largest
// magnitude swapped in, the column below the pivot scaled by the pivot's
// reciprocal, the trailing block updated with fused multiply-adds); the
// row swaps applied to b; then both triangular solves by blocks of rows
// from the top: within a block column by column (b_i -= b_k a_ik fused;
// the upper solve from the bottom, each b_k first divided by a_kk), then
// every row beyond the block less the block's dot product, summed with
// fused multiply-adds in ascending order. Blocks of TRSM_NB rows; a system
// of at most TRSM_WHOLE rows is one block (the probe: n = 18 one block,
// n = 24 to 48 blocks of 8). x is left in sh.b.
constexpr int TRSM_NB = 8;
constexpr int TRSM_WHOLE = 18;

__device__ void lu_solve(Shared& sh, int n, int lane) {
  for (int k = 0; k < n; ++k) {
    // pivot: the first row of largest |a_ik|, i >= k (a NaN never wins)
    double best = -1.0;
    int p = n;
    for (int i = k + lane; i < n; i += 32) {
      const double v = fabs(sh.a[i][k]);
      if (v > best) {
        best = v;
        p = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const double ob = __shfl_xor_sync(FULL, best, off);
      const int op = __shfl_xor_sync(FULL, p, off);
      if (ob > best || (ob == best && op < p)) {
        best = ob;
        p = op;
      }
    }
    if (p == n || isnan(sh.a[k][k])) p = k;
    // rows k and p swapped, and b with them (the same swaps in the same
    // order as applied to b after the factorization)
    if (p != k) {
      for (int j = lane; j < n; j += 32) {
        const double tmp = sh.a[k][j];
        sh.a[k][j] = sh.a[p][j];
        sh.a[p][j] = tmp;
      }
      if (lane == 0) {
        const double tmp = sh.b[k];
        sh.b[k] = sh.b[p];
        sh.b[p] = tmp;
      }
    }
    __syncwarp();
    const double rcp = __ddiv_rn(1.0, sh.a[k][k]);
    for (int i = k + 1 + lane; i < n; i += 32) {   // a row per lane
      const double l = __dmul_rn(sh.a[i][k], rcp);
      sh.a[i][k] = l;
      for (int j = k + 1; j < n; ++j)
        sh.a[i][j] = __fma_rn(-l, sh.a[k][j], sh.a[i][j]);
    }
    __syncwarp();
  }
  const int nb = n <= TRSM_WHOLE ? n : TRSM_NB;
  // the unit lower solve, blocks from the top
  for (int bs = 0; bs < n; bs += nb) {
    const int be = min(n, bs + nb);
    for (int k = bs; k < be; ++k) {
      const double bk = sh.b[k];
      for (int i = k + 1 + lane; i < be; i += 32)
        sh.b[i] = __fma_rn(-bk, sh.a[i][k], sh.b[i]);
      __syncwarp();
    }
    for (int i = be + lane; i < n; i += 32) {
      double d = 0.0;
      for (int k = bs; k < be; ++k) d = __fma_rn(sh.a[i][k], sh.b[k], d);
      sh.b[i] = __dsub_rn(sh.b[i], d);
    }
    __syncwarp();
  }
  // the upper solve, the same blocks from the last
  for (int bs = (n - 1) / nb * nb; bs >= 0; bs -= nb) {
    const int be = min(n, bs + nb);
    for (int k = be - 1; k >= bs; --k) {
      const double bk = __ddiv_rn(sh.b[k], sh.a[k][k]);
      __syncwarp();
      if (lane == 0) sh.b[k] = bk;
      for (int i = bs + lane; i < k; i += 32)
        sh.b[i] = __fma_rn(-bk, sh.a[i][k], sh.b[i]);
      __syncwarp();
    }
    for (int i = lane; i < bs; i += 32) {
      double d = 0.0;
      for (int k = bs; k < be; ++k) d = __fma_rn(sh.a[i][k], sh.b[k], d);
      sh.b[i] = __dsub_rn(sh.b[i], d);
    }
    __syncwarp();
  }
}

// ---- the sums over the points (warp tasks)

// Rows 3 h .. 3 h + 2 of the Schur term S[f, g] = sum_m (h_cp
// h_pp^-1)[f, m] h_cp[g, m]^T: 18 sums (half the block, so that the
// accumulators stay in registers)
__device__ void task_schur(const Scratch& s, int m, int f, int g, int h,
                           int f_dim, int lane, Shared& sh) {
  double acc[18];
#pragma unroll
  for (int o = 0; o < 18; ++o) acc[o] = 0.0;
  const float* a = s.a + (static_cast<long long>(f) * CP + 9 * h) * m;
  const float* hc = s.hcp + static_cast<long long>(g) * CP * m;
  for (int p = lane; p < m; p += 32) {
    float hb[CP], ab[9];
#pragma unroll
    for (int q = 0; q < CP; ++q) hb[q] = hc[static_cast<long long>(q) * m + p];
#pragma unroll
    for (int q = 0; q < 9; ++q) ab[q] = a[static_cast<long long>(q) * m + p];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        double t = __fma_rn(ab[3 * i], hb[3 * j], acc[6 * i + j]);
        t = __fma_rn(ab[3 * i + 1], hb[3 * j + 1], t);
        acc[6 * i + j] = __fma_rn(ab[3 * i + 2], hb[3 * j + 2], t);
      }
    }
  }
  warp_sum(acc);
  if (lane == 0) {
    float* out = sh.sc + (f * f_dim + g) * 36 + 18 * h;
#pragma unroll
    for (int o = 0; o < 18; ++o) out[o] = __double2float_rn(acc[o]);
  }
}

// Rows 3 h .. 3 h + 2 of h_cc's block and of g_c's (camera b, pose f):
// 18 + 3 sums over the points of sum_k jc_w[k]_i jc[k]_j and sum_k
// jc_w[k]_i r_k, jc_w = jc wr
__device__ void task_camera(const Window& in, const Scratch& s, int m,
                            int f_dim, int b, int f, int h, float x_off,
                            const Cam& c, int lane, Shared& sh) {
  double acc[21];
#pragma unroll
  for (int o = 0; o < 21; ++o) acc[o] = 0.0;
  const float* pts = s.pts[sh.cur];
  const float* wg = s.wg + static_cast<long long>(b * f_dim + f) * m;
  for (int p = lane; p < m; p += 32) {
    const long long o = static_cast<long long>(f) * m + p;
    const Obs ob = observe(sh.r[f], sh.t[f], pts[p], pts[m + p],
                           pts[2 * m + p], in.obs[b][2 * o],
                           in.obs[b][2 * o + 1], wg[p], b, x_off, c);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float jw0 = __fmul_rn(ob.jc[0][3 * h + i], ob.wr);
      const float jw1 = __fmul_rn(ob.jc[1][3 * h + i], ob.wr);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const double t = __fma_rn(jw0, ob.jc[0][j], acc[6 * i + j]);
        acc[6 * i + j] = __fma_rn(jw1, ob.jc[1][j], t);
      }
      const double t = __fma_rn(jw0, ob.rx, acc[18 + i]);
      acc[18 + i] = __fma_rn(jw1, ob.ry, t);
    }
  }
  warp_sum(acc);
  if (lane == 0) {
#pragma unroll
    for (int o = 0; o < 18; ++o)
      sh.hcc[b][f][18 * h + o] = __double2float_rn(acc[o]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      sh.gc[b][f][3 * h + i] = __double2float_rn(acc[18 + i]);
  }
}

// g_red's Schur term of pose f: sum_m (h_cp h_pp^-1)[f, m] g_p[m], 6 sums
__device__ void task_gred(const Scratch& s, int m, int f, int lane,
                          Shared& sh) {
  double acc[6];
#pragma unroll
  for (int o = 0; o < 6; ++o) acc[o] = 0.0;
  const float* a = s.a + static_cast<long long>(f) * CP * m;
  for (int p = lane; p < m; p += 32) {
    const float g0 = s.gp[p], g1 = s.gp[m + p], g2 = s.gp[2 * m + p];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      double t = __fma_rn(a[static_cast<long long>(3 * i) * m + p], g0, acc[i]);
      t = __fma_rn(a[static_cast<long long>(3 * i + 1) * m + p], g1, t);
      acc[i] = __fma_rn(a[static_cast<long long>(3 * i + 2) * m + p], g2, t);
    }
  }
  warp_sum(acc);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) sh.gpart[f][i] = __double2float_rn(acc[i]);
  }
}

// ---- the steps of one iteration

// (1) per point: h_cp [F, 6, 3] (each block's float64 sum over the two
// Jacobian rows rounded, the blocks added in float32), h_pp and g_p (each
// block's float64 sum over the poses and rows rounded, then added),
// h_pp^-1 = _inv33(h_pp, lambda), and h_cp h_pp^-1 for the poses that are
// not fixed
__device__ void point_blocks(const Window& in, const Scratch& s, int m,
                             int f_dim, float x_off, const Cam& c,
                             Shared& sh) {
  const float* pts = s.pts[sh.cur];
  const float lam = sh.lam;
  for (int p = threadIdx.x; p < m; p += THREADS) {
    const float x = pts[p], y = pts[m + p], z = pts[2 * m + p];
    // per block b: h_pp's (00 01 02 11 12 22) and g_p's float64 sums over
    // the poses
    double ah[NB][6] = {}, ag[NB][3] = {};
    for (int f = 0; f < f_dim; ++f) {
      const long long o = static_cast<long long>(f) * m + p;
      float hcp[CP];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const Obs ob = observe(sh.r[f], sh.t[f], x, y, z, in.obs[b][2 * o],
                               in.obs[b][2 * o + 1],
                               s.wg[static_cast<long long>(b) * f_dim * m + o],
                               b, x_off, c);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float jw0 = __fmul_rn(ob.jc[0][i], ob.wr);
          const float jw1 = __fmul_rn(ob.jc[1][i], ob.wr);
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float v = __double2float_rn(
                __fma_rn(jw1, ob.jp[1][j], __dmul_rn(jw0, ob.jp[0][j])));
            hcp[3 * i + j] = b == 0 ? __fadd_rn(0.0f, v)
                                    : __fadd_rn(hcp[3 * i + j], v);
          }
        }
        // h_pp's and g_p's terms: (sum_k jp_ki jp_kj) wr, (sum_k jp_ki r_k) wr
        const double wr = ob.wr;
        int o6 = 0;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = i; j < 3; ++j, ++o6) {
            const double t = __fma_rn(ob.jp[1][i], ob.jp[1][j],
                                      __dmul_rn(ob.jp[0][i], ob.jp[0][j]));
            ah[b][o6] = __dadd_rn(ah[b][o6], __dmul_rn(t, wr));
          }
          const double t = __fma_rn(ob.jp[1][i], ob.ry,
                                    __dmul_rn(ob.jp[0][i], ob.rx));
          ag[b][i] = __dadd_rn(ag[b][i], __dmul_rn(t, wr));
        }
      }
      float* dst = s.hcp + static_cast<long long>(f) * CP * m + p;
#pragma unroll
      for (int q = 0; q < CP; ++q) dst[static_cast<long long>(q) * m] = hcp[q];
    }
    float hpp[6], gp[3];
#pragma unroll
    for (int o6 = 0; o6 < 6; ++o6)
      hpp[o6] = __fadd_rn(__fadd_rn(0.0f, __double2float_rn(ah[0][o6])),
                          __double2float_rn(ah[1][o6]));
#pragma unroll
    for (int i = 0; i < 3; ++i)
      gp[i] = __fadd_rn(__fadd_rn(0.0f, __double2float_rn(ag[0][i])),
                        __double2float_rn(ag[1][i]));
    // _inv33(h_pp, lam): the adjugate of h_pp + lam I over its determinant
    const float lam_i[3][3] = {{__fmul_rn(lam, 1.0f), __fmul_rn(lam, 0.0f),
                                __fmul_rn(lam, 0.0f)},
                               {__fmul_rn(lam, 0.0f), __fmul_rn(lam, 1.0f),
                                __fmul_rn(lam, 0.0f)},
                               {__fmul_rn(lam, 0.0f), __fmul_rn(lam, 0.0f),
                                __fmul_rn(lam, 1.0f)}};
    const float a00 = __fadd_rn(hpp[0], lam_i[0][0]);
    const float a01 = __fadd_rn(hpp[1], lam_i[0][1]);
    const float a02 = __fadd_rn(hpp[2], lam_i[0][2]);
    const float a10 = __fadd_rn(hpp[1], lam_i[1][0]);
    const float a11 = __fadd_rn(hpp[3], lam_i[1][1]);
    const float a12 = __fadd_rn(hpp[4], lam_i[1][2]);
    const float a20 = __fadd_rn(hpp[2], lam_i[2][0]);
    const float a21 = __fadd_rn(hpp[4], lam_i[2][1]);
    const float a22 = __fadd_rn(hpp[5], lam_i[2][2]);
    const float cof[9] = {
        __fsub_rn(__fmul_rn(a11, a22), __fmul_rn(a12, a21)),
        __fsub_rn(__fmul_rn(a02, a21), __fmul_rn(a01, a22)),
        __fsub_rn(__fmul_rn(a01, a12), __fmul_rn(a02, a11)),
        __fsub_rn(__fmul_rn(a12, a20), __fmul_rn(a10, a22)),
        __fsub_rn(__fmul_rn(a00, a22), __fmul_rn(a02, a20)),
        __fsub_rn(__fmul_rn(a02, a10), __fmul_rn(a00, a12)),
        __fsub_rn(__fmul_rn(a10, a21), __fmul_rn(a11, a20)),
        __fsub_rn(__fmul_rn(a01, a20), __fmul_rn(a00, a21)),
        __fsub_rn(__fmul_rn(a00, a11), __fmul_rn(a01, a10))};
    const float det = __fadd_rn(
        __fadd_rn(__fmul_rn(a00, cof[0]), __fmul_rn(a01, cof[1])),
        __fmul_rn(a02, cof[2]));
    const float inv_det =
        __fdiv_rn(1.0f, fabsf(det) < 1e-18f ? 1e-18f : det);
    float hinv[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      hinv[q] = __fmul_rn(cof[q], inv_det);
      s.hinv[static_cast<long long>(q) * m + p] = hinv[q];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) s.gp[static_cast<long long>(i) * m + p] = gp[i];
    // h_cp h_pp^-1: [6, 3] x [3, 3] per pose, float64 sums rounded once
    for (int f = 1; f < f_dim; ++f) {
      const float* hcp = s.hcp + static_cast<long long>(f) * CP * m + p;
      float* a = s.a + static_cast<long long>(f) * CP * m + p;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float h0 = hcp[static_cast<long long>(3 * i) * m];
        const float h1 = hcp[static_cast<long long>(3 * i + 1) * m];
        const float h2 = hcp[static_cast<long long>(3 * i + 2) * m];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          double t = __dmul_rn(h0, hinv[k]);
          t = __fma_rn(h1, hinv[3 + k], t);
          t = __fma_rn(h2, hinv[6 + k], t);
          a[static_cast<long long>(3 * i + k) * m] = __double2float_rn(t);
        }
      }
    }
  }
}

// (3) the reduced system in float32 as bundle.py builds it, widened:
// S = -Schur, plus (h_cc + lam I) on the diagonal blocks; g_red = g_c -
// Schur term; the fixed pose's rows and columns the identity, its
// right-hand side zero; b = -g_red
__device__ void assemble(int f_dim, Shared& sh) {
  const int n = 6 * f_dim;
  const float lam = sh.lam;
  for (int e = threadIdx.x; e < n * n; e += THREADS) {
    const int r = e / n, c = e % n;
    const int f = r / 6, i = r % 6, g = c / 6, j = c % 6;
    float v;
    if (r < 6 || c < 6) {
      v = r == c ? 1.0f : 0.0f;
    } else {
      v = -sh.sc[(f * f_dim + g) * 36 + 6 * i + j];
      if (f == g) {
        const float hcc = __fadd_rn(__fadd_rn(0.0f, sh.hcc[0][f][6 * i + j]),
                                    sh.hcc[1][f][6 * i + j]);
        v = __fadd_rn(v, __fadd_rn(hcc, __fmul_rn(lam, i == j ? 1.0f : 0.0f)));
      }
    }
    sh.a[r][c] = v;
  }
  for (int r = threadIdx.x; r < n; r += THREADS) {
    const int f = r / 6, i = r % 6;
    float g = 0.0f;
    if (r >= 6) {
      const float gc = __fadd_rn(__fadd_rn(0.0f, sh.gc[0][f][i]), sh.gc[1][f][i]);
      g = __fsub_rn(gc, sh.gpart[f][i]);
    }
    sh.b[r] = -g;
  }
}

// (4) per point: dp = -h_pp^-1 (g_p + sum_f h_cp[f]^T dc_f) and the trial
// position; a non-finite dp marks the step bad
__device__ void point_steps(const Scratch& s, int m, int f_dim, Shared& sh) {
  const float* pts = s.pts[sh.cur];
  float* trial = s.pts[1 - sh.cur];
  bool bad = false;
  for (int p = threadIdx.x; p < m; p += THREADS) {
    float t[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      double acc = 0.0;
      for (int f = 0; f < f_dim; ++f) {
        const float* hcp = s.hcp + static_cast<long long>(f) * CP * m + p;
#pragma unroll
        for (int i = 0; i < 6; ++i)
          acc = __fma_rn(hcp[static_cast<long long>(3 * i + j) * m],
                         sh.dc[6 * f + i], acc);
      }
      t[j] = __fadd_rn(s.gp[static_cast<long long>(j) * m + p],
                       __double2float_rn(acc));
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      double acc = __dmul_rn(s.hinv[static_cast<long long>(3 * i) * m + p], t[0]);
      acc = __fma_rn(s.hinv[static_cast<long long>(3 * i + 1) * m + p], t[1], acc);
      acc = __fma_rn(s.hinv[static_cast<long long>(3 * i + 2) * m + p], t[2], acc);
      const float dp = -__double2float_rn(acc);
      bad = bad || !isfinite(dp);
      trial[static_cast<long long>(i) * m + p] =
          __fadd_rn(pts[static_cast<long long>(i) * m + p], dp);
    }
  }
  if (bad) sh.bad = 1;
}

// (5) the robust chi-square's two blocks at the poses (r, t) and the
// positions pts, float64 sums of float32 terms, into sh.sums[0..1]
__device__ void robust_chi2(const Window& in, const Scratch& s, int m,
                            int f_dim, float x_off, const Cam& c,
                            const float (*r)[9], const float (*t)[3],
                            const float* pts, Shared& sh) {
  double v[2] = {0.0, 0.0};
  for (int p = threadIdx.x; p < m; p += THREADS) {
    const float x = pts[p], y = pts[m + p], z = pts[2 * m + p];
    for (int b = 0; b < NB; ++b) {
      for (int f = 0; f < f_dim; ++f) {
        const long long o = static_cast<long long>(f) * m + p;
        float lx, ly, lz;
        camera_point(r[f], t[f], x, y, z, lx, ly, lz);
        const Proj pr = project_cam(b == 0 ? lx : __fadd_rn(lx, x_off), ly,
                                    lz, in.obs[b][2 * o], in.obs[b][2 * o + 1],
                                    c);
        const float w = s.wg[static_cast<long long>(b) * f_dim * m + o];
        v[b] = __dadd_rn(v[b], static_cast<double>(rho(w, pr.e2, c)));
      }
    }
  }
  block_sum<2>(v, sh);
}

// the total of the robust chi-square's two rounded blocks
__device__ float chi2_total(const Shared& sh) {
  return __fadd_rn(__fadd_rn(0.0f, __double2float_rn(sh.sums[0])),
                   __double2float_rn(sh.sums[1]));
}

// weighted_point_e2 at the original poses of the point (x, y, z): each
// block's float64 sum over the poses of w e2, rounded, then added
__device__ float point_e2(const Window& in, const Scratch& s, int m,
                          int f_dim, int p, float x, float y, float z,
                          float x_off, const Cam& c, const Shared& sh) {
  float total = 0.0f;
  for (int b = 0; b < NB; ++b) {
    double acc = 0.0;
    for (int f = 0; f < f_dim; ++f) {
      const long long o = static_cast<long long>(f) * m + p;
      float lx, ly, lz;
      camera_point(sh.r0[f], sh.t0[f], x, y, z, lx, ly, lz);
      const Proj pr = project_cam(b == 0 ? lx : __fadd_rn(lx, x_off), ly, lz,
                                  in.obs[b][2 * o], in.obs[b][2 * o + 1], c);
      const float w = s.wg[static_cast<long long>(b) * f_dim * m + o];
      acc = __dadd_rn(acc, static_cast<double>(__fmul_rn(w, pr.e2)));
    }
    total = __fadd_rn(total, __double2float_rn(acc));
  }
  return total;
}

// ---- the whole body: one block per stream

__global__ void __launch_bounds__(THREADS, 1) ba_refine_kernel(
    const float* __restrict__ t_in, const float* __restrict__ q_in,
    const float* __restrict__ pos_in, const float* __restrict__ obs_l,
    const float* __restrict__ w_l, const float* __restrict__ obs_r,
    const float* __restrict__ w_r, int f_dim, int m, int iters, Cam cam,
    float x_off, float gate_th2, float* __restrict__ scratch,
    float* __restrict__ pos_out, float* __restrict__ chi2_out,
    long long* __restrict__ n_obs_out, unsigned char* __restrict__ accepted) {
  __shared__ Shared sh;
  const long long st = blockIdx.x;
  const long long fm = static_cast<long long>(f_dim) * m;
  const Window in{t_in + st * f_dim * 3, q_in + st * f_dim * 4,
                  pos_in + st * m * 3, {obs_l + st * fm * 2, obs_r + st * fm * 2},
                  {w_l + st * fm, w_r + st * fm}};
  const Scratch s(scratch + st * scratch_per_point(f_dim) * m, f_dim, m);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (st == 0 && threadIdx.x == 0) atomicAdd(&g_launches, 1ull);

  if (threadIdx.x < f_dim) {
    const int f = threadIdx.x;
    world_to_camera(in.t + 3 * f, in.q + 4 * f, sh.r0[f], sh.t0[f]);
#pragma unroll
    for (int i = 0; i < 9; ++i) sh.r[f][i] = sh.r0[f][i];
#pragma unroll
    for (int i = 0; i < 3; ++i) sh.t[f][i] = sh.t0[f][i];
    if (f == f_dim - 1) {
#pragma unroll
      for (int i = 0; i < 3; ++i) sh.tn[i] = in.t[3 * f + i];
    }
  }
  if (threadIdx.x == 0) {
    sh.cur = 0;
    sh.lam = 1e-4f;
    sh.nu = 2.0f;
  }
  __syncthreads();

  // the gate: gate = max(gate_th2, 3 x the mean e2 of the observations
  // with e2 <= 4 x the plain mean)
  gate_moments(in, f_dim, m, x_off, cam, false, 0.0f, sh);
  if (threadIdx.x == 0) sh.gate = __fmul_rn(4.0f, mean_e2(sh));
  __syncthreads();
  gate_moments(in, f_dim, m, x_off, cam, true, sh.gate, sh);
  if (threadIdx.x == 0) sh.gate = clamp_min(__fmul_rn(3.0f, mean_e2(sh)), gate_th2);
  __syncthreads();

  // the gated weights, `use`, the positions, and the fit at the original
  // state; the observation count
  int n_obs = 0;
  for (int p = threadIdx.x; p < m; p += THREADS) {
    const float x = in.pos[3 * p], y = in.pos[3 * p + 1], z = in.pos[3 * p + 2];
    float wgt[NB][MAX_F];
    int n_l = 0, n_s = 0;
    for (int f = 0; f < f_dim; ++f) {
      const long long o = static_cast<long long>(f) * m + p;
      float lx, ly, lz;
      camera_point(sh.r0[f], sh.t0[f], x, y, z, lx, ly, lz);
      for (int b = 0; b < NB; ++b) {
        const Proj pr = project_cam(b == 0 ? lx : __fadd_rn(lx, x_off), ly,
                                    lz, in.obs[b][2 * o], in.obs[b][2 * o + 1],
                                    cam);
        wgt[b][f] = __fmul_rn(in.w[b][o], pr.e2 <= sh.gate ? 1.0f : 0.0f);
      }
      n_l += wgt[0][f] > 0.0f;
      n_s += wgt[0][f] > 0.0f && wgt[1][f] > 0.0f;
    }
    const float use = n_l >= 2 && n_s >= 1 ? 1.0f : 0.0f;
    for (int b = 0; b < NB; ++b) {
      for (int f = 0; f < f_dim; ++f) {
        const float w = __fmul_rn(wgt[b][f], use);
        s.wg[(static_cast<long long>(b) * f_dim + f) * m + p] = w;
        n_obs += w > 0.0f;
      }
    }
    s.use[p] = use;
    s.pts[0][p] = x;
    s.pts[0][m + p] = y;
    s.pts[0][2 * m + p] = z;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < m; p += THREADS) {
    s.e2_old[p] = point_e2(in, s, m, f_dim, p, in.pos[3 * p],
                           in.pos[3 * p + 1], in.pos[3 * p + 2], x_off, cam, sh);
  }
  n_obs = block_count(n_obs, sh);
  robust_chi2(in, s, m, f_dim, x_off, cam, sh.r0, sh.t0, s.pts[0], sh);
  if (threadIdx.x == 0) {
    sh.chi2 = chi2_total(sh);
    n_obs_out[st] = n_obs;
  }
  __syncthreads();

  const int n = 6 * f_dim, nf = f_dim - 1;
  for (int it = 0; it < iters; ++it) {
    point_blocks(in, s, m, f_dim, x_off, cam, sh);
    if (threadIdx.x == 0) sh.bad = 0;
    __syncthreads();
    // the sums over the points, of the free poses f, g >= 1: Schur
    // blocks (f, g) and camera blocks (b, f) by halves, g_red's terms (f)
    const int n_schur = 2 * nf * nf, n_cam = 2 * NB * nf;
    for (int task = warp; task < n_schur + n_cam + nf; task += WARPS) {
      if (task < n_schur) {
        const int k = task / 2;
        task_schur(s, m, 1 + k / nf, 1 + k % nf, task % 2, f_dim, lane, sh);
      } else if (task < n_schur + n_cam) {
        const int k = (task - n_schur) / 2;
        task_camera(in, s, m, f_dim, k / nf, 1 + k % nf, (task - n_schur) % 2,
                    x_off, cam, lane, sh);
      } else {
        task_gred(s, m, 1 + task - n_schur - n_cam, lane, sh);
      }
    }
    __syncthreads();
    assemble(f_dim, sh);
    __syncthreads();
    if (warp == 0) {
      lu_solve(sh, n, lane);
      for (int r = lane; r < n; r += 32) {
        sh.dc[r] = __double2float_rn(sh.b[r]);
        if (!isfinite(sh.dc[r])) sh.bad = 1;
      }
    }
    __syncthreads();
    if (threadIdx.x < f_dim) {
      const int f = threadIdx.x;
      retract(sh.r[f], sh.t[f], sh.dc + 6 * f, sh.rt[f], sh.tt[f]);
    }
    point_steps(s, m, f_dim, sh);
    __syncthreads();
    robust_chi2(in, s, m, f_dim, x_off, cam, sh.rt, sh.tt, s.pts[1 - sh.cur],
                sh);
    if (threadIdx.x == 0) {
      const float chi2_new = chi2_total(sh);
      const bool ok = chi2_new < sh.chi2 && sh.bad == 0;
      if (ok) {
        for (int f = 0; f < f_dim; ++f) {
#pragma unroll
          for (int i = 0; i < 9; ++i) sh.r[f][i] = sh.rt[f][i];
#pragma unroll
          for (int i = 0; i < 3; ++i) sh.t[f][i] = sh.tt[f][i];
        }
        sh.lam = __fdiv_rn(sh.lam, 3.0f);
        sh.nu = 2.0f;
        sh.chi2 = chi2_new;
        sh.cur = 1 - sh.cur;
      } else {
        sh.lam = __fmul_rn(sh.lam, sh.nu);
        sh.nu = __fmul_rn(sh.nu, 2.0f);
      }
      accepted[st * iters + it] = ok;
    }
    __syncthreads();
  }

  // the writeback: a refined point is kept where it takes part, stays
  // within 10% of its distance to the newest camera + 0.5 m, and fits the
  // gated observations at the original poses no worse than before
  const float* pts = s.pts[sh.cur];
  for (int p = threadIdx.x; p < m; p += THREADS) {
    const float x0 = in.pos[3 * p], y0 = in.pos[3 * p + 1], z0 = in.pos[3 * p + 2];
    const float x = pts[p], y = pts[m + p], z = pts[2 * m + p];
    const float dist = norm3(__fsub_rn(x0, sh.tn[0]), __fsub_rn(y0, sh.tn[1]),
                             __fsub_rn(z0, sh.tn[2]));
    const float step = norm3(__fsub_rn(x, x0), __fsub_rn(y, y0), __fsub_rn(z, z0));
    bool ok = s.use[p] > 0.0f &&
              step <= __fadd_rn(__fmul_rn(0.1f, dist), 0.5f);
    ok = ok && point_e2(in, s, m, f_dim, p, x, y, z, x_off, cam, sh) <=
                   s.e2_old[p];
    float* out = pos_out + st * m * 3 + 3 * p;
    out[0] = ok ? x : x0;
    out[1] = ok ? y : y0;
    out[2] = ok ? z : z0;
  }
  if (threadIdx.x == 0) chi2_out[st] = sh.chi2;
}

}  // namespace

// S streams of local BA's body: window poses t [S, F, 3], q [S, F, 4], map
// positions [S, M, 3], observations obs_l, obs_r [S, F, M, 2] and weights
// w_l, w_r [S, F, M] float32; the camera, the right camera's x offset in
// the left frame (-baseline), the gate's floor, the LM iterations;
// scratch [S, M * lvt_ba_scratch_per_point(F)] float32; outputs pos [S, M, 3],
// chi2 [S] float32, n_obs [S] int64, accepted [S, iters] bool. One block
// per stream; F <= lvt_ba_max_window().
extern "C" int lvt_ba_max_window() { return MAX_F; }

// The launches of the kernel on the current device so far (g_launches),
// read after the device has finished all it was given
extern "C" int lvt_ba_launches(long long* out) {
  unsigned long long n = 0;
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(&n, g_launches, sizeof n);
  *out = static_cast<long long>(n);
  return static_cast<int>(err);
}

// floats of scratch per stream and map point
extern "C" int lvt_ba_scratch_per_point(int f_dim) {
  return scratch_per_point(f_dim);
}

extern "C" int lvt_ba_refine(const float* t, const float* q, const float* pos,
                             const float* obs_l, const float* w_l,
                             const float* obs_r, const float* w_r,
                             int n_streams, int f_dim, int m, int iters,
                             float fx, float fy, float cx, float cy,
                             float th2, float x_off, float gate_th2,
                             float* scratch, float* pos_out, float* chi2,
                             long long* n_obs, void* accepted, void* stream) {
  if (f_dim < 1 || f_dim > MAX_F || m < 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_streams > 0) {
    ba_refine_kernel<<<n_streams, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        t, q, pos, obs_l, w_l, obs_r, w_r, f_dim, m, iters,
        Cam{fx, fy, cx, cy, th2}, x_off, gate_th2, scratch, pos_out, chi2,
        n_obs, static_cast<unsigned char*>(accepted));
  }
  return static_cast<int>(cudaGetLastError());
}
