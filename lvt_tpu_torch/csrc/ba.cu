// Local BA's whole body for Hopper: one thread-block cluster of CLUSTER
// blocks per stream computes, in one launch for all S streams
// (ba_refine_kernel), what lvt_tpu_torch/core/step.py::_refine_structure
// computes without a group: the chi-square gate of the window's
// observations (solver/bundle.py::chi2_gate_weights), the points that take
// part (>= 2 left observations and >= 1 stereo pair), the predicated
// Levenberg-Marquardt iterations of bundle.py::refine_window (the Schur
// complement onto the cameras, the gauge fix, the reduced solve, the
// back-substitution for the points, the retraction and the accept test),
// then the trust region and the improvement test of each refined point
// (two bundle.py::weighted_point_e2 sums) and the select. It is not a TPU
// kernel: lvt_tpu runs this as XLA ops under jit
// (lvt_tpu/solver/bundle.py:93-378, called from the lax.cond of
// lvt_tpu/core/step.py:269-318). In PyTorch the same body was about 3200
// small kernels, copies and fills once per BA frame. ba_phase_kernel runs
// the same body in phases, for the sharded step (below).
//
// What bounds it. The work is a few float64 multiply-adds per
// observation and iteration (the bound is ~1e-4 ms at M = 1024), but every
// iteration is a chain of dependent phases: per-point blocks, sums over
// the points, a small dense solve, per-point steps, a sum over the points
// again. On one SM per stream the sums and the per-point work took 3/4 of
// an iteration and the solve the rest. So the points are spread over a
// cluster of SMs, and the solve over the threads of each block.
//
// Who does what. Block rank r of a stream's cluster owns the contiguous
// slice [r M / C, (r + 1) M / C) of the M points (C = CLUSTER; a slice may
// be empty) and runs every per-point phase on its slice only: the gate's
// sweeps, the mask, the fit at the original state, the per-point blocks,
// the steps, the trial chi-square and the writeback. Everything per point
// lives in a scratch row of device memory per stream (structure of
// arrays), of which each block reads and writes its own slice: the
// current and trial positions, the gated weights, the old fit e2, the mask
// `use`, and per iteration h_cp [F, 6, 3], h_cp h_pp^-1 [F, 6, 3], g_p [3]
// and h_pp^-1 [3, 3]. Every sum over the points is a float64 partial per
// block over its slice; after a cluster barrier every block reads all C
// partials from the others' shared memory (distributed shared memory) and
// adds them in rank order 0..C-1, then rounds once to float32. So every
// block holds the same totals without a broadcast, assembles and solves
// the reduced system itself, and takes the same accept decision; rank 0
// alone writes chi2, n_obs and the accept bits. The poses (world to camera,
// current, original and trial), lambda, nu and the reduced system live in
// each block's shared memory.
//
// One iteration. (1) A lane pair per point, the even lane observing the
// left camera and the odd one the right (their rounded terms traded by a
// shuffle and added in block order): every observation block and pose
// gives the residual, the Cauchy weight and the Jacobians; per point h_cp,
// h_pp and g_p, h_pp^-1 (the adjugate, as _inv33) and h_cp h_pp^-1, each
// lane writing half the rows. (2) Warp-per-sum over the block's slice, each
// warp one task with its lanes striding over the points, folded over the
// lanes (lm_common.cuh::fold): S's 6x6 block (f, g) (Schur term), h_cc's
// and g_c's block (camera b, pose f) (its Jacobians recomputed from the
// point: the same operations, so the same bits), or g_red's Schur term of
// pose f. The fixed pose's rows and
// columns become the identity (the gauge fix), so no task computes them.
// (3) The exchange: a cluster barrier, then the reduced system assembled
// from the C partials in float32 as the plain version does, widened. (4)
// The solve: LU with partial pivoting by the block, then the two
// triangular solves by one warp. (5) Thread-per-point: dp = -h_pp^-1 (g_p
// + h_cp^T dc), the trial positions; the poses retracted. (6) The robust
// chi-square at the trial state (a lane pair per point, as the gate's
// sweeps; a cluster sum, with the count of non-finite dp), and the accept
// test: a rejected step keeps the state and only adapts lambda; a
// non-finite dc or dp is rejected.
//
// The solve. The LU keeps, for every element, the sequence of operations
// of cuBLAS's getf2 (see lu_factor), but rows are relabelled by a
// permutation instead of moved, the pivot is found by a warp's integer
// max/min reductions on the magnitudes' bits, the pivot row is read from
// shared memory (a broadcast), and the trailing update's (n - k - 1)^2
// independent fused multiply-adds are spread over the block's threads.
// The rows have an odd stride, so a column's rows lie in distinct banks.
// The first 6 steps are skipped: the gauge fix makes the first 6 columns
// those of the identity, where each such step computes l = 0 x 1 = +0 and
// a_ij + (-0 x 0) = a_ij for every a_ij (signed zeros and NaNs included),
// so the matrix keeps its bits. The triangular solves keep every step.
//
// Rounding. The per-point float32 arithmetic is the plain version's
// operation by operation (lm_common.cuh: __fmul_rn and friends, no fused
// multiply-add, the IEEE divisions, log1pf, sinf and cosf as torch's
// kernels call them). Every contraction the plain version runs through
// bundle.py::_einsum64 / _wide / _sum64 is a float64 sum of products of
// float32 numbers (exact in float64), rounded once to float32; here the
// same products are summed in float64 in a fixed order (each block's
// slice in its fixed order, then the blocks in rank order) and rounded
// once (an exact product added is a fused multiply-add of its two
// factors). Another order moves a float64 sum by ~1e-16 of its terms'
// magnitudes, so it rounds to the same float32 unless its terms cancel:
// tests/test_torch_ba_refine.py finds every sum over slices of C = 1 to
// 16 points equal where the terms cancel by less than 2^20, and a few of
// h_cc's entries (cancelling by 2^26 or more) a float32 apart, as they
// are between the card's einsum and the CPU's; the body's outputs stay
// the plain version's bits.
// The float64 solve follows the order of operations of the one the plain
// version runs on the card (cuBLAS's batched LU and triangular solves): a
// window of few points leaves the reduced system ill-conditioned enough
// that another order moves dc by a float32 ulp. Every order here depends
// on M, F and C alone, never on S or on which SMs are free, so a stream of
// an S-stream launch gets the bits of its own S = 1 launch.
//
// The sharded body (ba_phase_kernel). Where the points are a rank's block
// of a map sharded over ranks (lvt_tpu's psum_axis), every sum over the
// points must be summed over the ranks, and a collective cannot run inside
// a kernel. So the same body runs as one launch per phase, split where the
// body sums over the points: the gate's first moments, its second ones,
// the gated weights with the first chi-square and the count, per LM
// iteration the per-point blocks with the iteration's sums and then the
// solve with the trial step and its chi-square, and last the accept test
// and the writeback. A phase writes its cluster's float64 totals (the
// blocks' partials added in rank order, as ba_refine_kernel adds them);
// the caller all-reduces them, and the next phase rounds each total once.
// What ba_refine_kernel keeps in shared memory between these points (the
// poses, lambda, nu, chi2, which positions are current, the accept bits)
// goes through a state row per stream, its scratch row from phase to
// phase (each block copies its slice). So on one rank every phase sees
// ba_refine_kernel's values, and the result is its bits. The accept test
// runs at the start of the next phase; a non-finite dp counts over this
// rank's points only, as in the plain group version.
//
// Sizes: any M; F up to MAX_F poses (the wrapper refuses more), the first
// pose fixed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lm_common.cuh"

// A phase boundary, and one inside the solve (read by thread 0):
// scripts/torch_ba_phase_clocks.py defines them to read the SM clock; the
// kernel's own build leaves nothing of them.
#ifndef BA_PHASE_CLOCK
#define BA_PHASE_CLOCK(slot)
#endif
#ifndef BA_SOLVE_CLOCK
#define BA_SOLVE_CLOCK(part)
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;          // blocks per stream (the portable limit)
constexpr int THREADS = 256;        // threads per block
constexpr int WARPS = THREADS / 32;
constexpr int MAX_F = 8;            // window poses per stream
constexpr int MAX_N = 6 * MAX_F;    // the reduced camera system's size
constexpr int LDA = MAX_N + 1;      // its row stride: odd, see lu_factor
constexpr int NB = 2;               // observation blocks: left, right camera
constexpr int CP = 18;              // a point's 6 x 3 block of h_cp per pose
constexpr int SMALL = 4;            // the most values of one small sum

// One iteration's sums over the points, as a block's float64 partials
// (Shared::iter), one task's each: per pair of free poses (f, g) S's 6x6
// block (SCHUR values, row major), per camera block b and free pose f
// h_cc's 6x6 block and g_c's 6 (CAM), per free pose f g_red's Schur term
// (GRED); every index of a free pose is 1..F-1.
constexpr int SCHUR = 36, CAM = 42, GRED = 6;
constexpr int MAX_FREE = MAX_F - 1;
constexpr int ITER_SUMS =
    SCHUR * MAX_FREE * MAX_FREE + NB * CAM * MAX_FREE + GRED * MAX_FREE;

__device__ __forceinline__ int schur_at(int f, int g, int nf) {
  return SCHUR * ((f - 1) * nf + g - 1);
}
__device__ __forceinline__ int cam_at(int b, int f, int nf) {
  return SCHUR * nf * nf + CAM * (b * nf + f - 1);
}
__device__ __forceinline__ int gred_at(int f, int nf) {
  return SCHUR * nf * nf + NB * CAM * nf + GRED * (f - 1);
}

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

// shared state of one block of a stream's cluster
struct Shared {
  float r0[MAX_F][9], t0[MAX_F][3];    // the original poses, world to camera
  float r[MAX_F][9], t[MAX_F][3];      // the current ones
  float rt[MAX_F][9], tt[MAX_F][3];    // the trial ones
  float tn[3];                         // the newest pose's position
  double a[MAX_N][LDA];  // the reduced system, then its LU (rows by perm)
  double b[MAX_N];       // its right-hand side
  double y[MAX_N];       // b permuted, then the solution
  int perm[MAX_N];       // the LU's row labels: logical row i is a[perm[i]]
  float dc[MAX_N];
  double part[WARPS][SMALL];  // a small sum's partials of the warps
  double red[2][SMALL];  // this block's partial of a small sum (read by the
                         // cluster), alternating between two buffers
  double sums[SMALL];    // the cluster's totals of a small sum
  double iter[ITER_SUMS];  // this block's partials of an iteration's sums
                           // (read by the cluster)
  float lam, nu, chi2, gate;
  int cur;       // which of Scratch::pts holds the current positions
  int bad;       // a non-finite dc (ba_phase_kernel: or dp)
  float n_obs;   // ba_phase_kernel: the observation count
  bool ok;       // ba_phase_kernel: the accept test's outcome
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

// ---- sums over the cluster; every thread of every block calls them

// The N float64 values of every thread summed over the stream's points
// into sh.sums: this block's partial (each warp by an xor butterfly, then
// the warps in order) into sh.red[par], a cluster barrier, then every
// block adds the C blocks' partials in rank order. `par` alternates, so a
// buffer is written again only after the next call's barrier, by which
// every block has read it.
template <int N>
__device__ void cluster_sum(double (&v)[N], Shared& sh, int& par) {
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
    sh.red[par][threadIdx.x] = s;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (threadIdx.x < N) {
    double* mine = &sh.red[par][threadIdx.x];
    double s = *cluster.map_shared_rank(mine, 0);
#pragma unroll
    for (int r = 1; r < CLUSTER; ++r)
      s = __dadd_rn(s, *cluster.map_shared_rank(mine, r));
    sh.sums[threadIdx.x] = s;
  }
  __syncthreads();
  par ^= 1;
}

// The cluster's total of an iteration's partial sh.iter[off]: the C
// blocks' partials in rank order, rounded once
__device__ __forceinline__ float iter_total(cg::cluster_group& cluster,
                                            Shared& sh, int off) {
  double* mine = sh.iter + off;
  double s = *cluster.map_shared_rank(mine, 0);
#pragma unroll
  for (int r = 1; r < CLUSTER; ++r)
    s = __dadd_rn(s, *cluster.map_shared_rank(mine, r));
  return __double2float_rn(s);
}

// ---- the gate (chi2_gate_weights) and the points that take part

// Sweep of the block's points [lo, hi) at the original state: the float64
// sums of the weights and of weight x e2 of both blocks, with each weight
// w_b cut to w_b * (e2 <= cut) if `trim`, into v (zero before): [sum w_0,
// sum w_1, sum w_0 e2, sum w_1 e2]; lanes 2q and 2q + 1 share a point, the
// even one summing the left block, the odd one the right.
__device__ void gate_moments(const Window& in, int lo, int hi, int f_dim,
                             int m, float x_off, const Cam& c, bool trim,
                             float cut, const Shared& sh, double (&v)[4]) {
  const int b = threadIdx.x & 1;
  double sw = 0.0, se = 0.0;
  for (int p = lo + (threadIdx.x >> 1); p < hi; p += THREADS / 2) {
    const float x = in.pos[3 * p], y = in.pos[3 * p + 1],
                z = in.pos[3 * p + 2];
    for (int f = 0; f < f_dim; ++f) {
      const long long o = static_cast<long long>(f) * m + p;
      float lx, ly, lz;
      camera_point(sh.r0[f], sh.t0[f], x, y, z, lx, ly, lz);
      const Proj pr = project_cam(b == 0 ? lx : __fadd_rn(lx, x_off), ly, lz,
                                  in.obs[b][2 * o], in.obs[b][2 * o + 1], c);
      const float w = trim ? __fmul_rn(in.w[b][o], pr.e2 <= cut ? 1.0f : 0.0f)
                           : in.w[b][o];
      sw = __dadd_rn(sw, static_cast<double>(w));
      se = __dadd_rn(se, static_cast<double>(__fmul_rn(w, pr.e2)));
    }
  }
  v[0] = b == 0 ? sw : 0.0;
  v[1] = b == 0 ? 0.0 : sw;
  v[2] = b == 0 ? se : 0.0;
  v[3] = b == 0 ? 0.0 : se;
}

// mean_e2: (sum w e2) / clamp(sum w, min=1) from the gate's moments
// (gate_moments' order), each rounded once
__device__ float mean_e2(const double* sums) {
  const float n = clamp_min(
      __fadd_rn(__fadd_rn(0.0f, __double2float_rn(sums[0])),
                __double2float_rn(sums[1])),
      1.0f);
  const float e = __fadd_rn(__fadd_rn(0.0f, __double2float_rn(sums[2])),
                            __double2float_rn(sums[3]));
  return __fdiv_rn(e, n);
}

// ---- the reduced camera solve

// The n x n system in sh.a, sh.b solved in the order of operations of
// bundle.py::_solve64 on the card (cuBLAS's batched LU and its triangular
// solves; scripts/torch_ba_lu_probe.py matched each step on every system it
// recorded, bit for bit in float64): the LU with partial pivoting as
// LAPACK's getf2 (at column k the first row of largest magnitude swapped
// in, a NaN never winning; the column below the pivot scaled by the
// pivot's reciprocal, 1 / a_kk by __ddiv_rn; the trailing block updated as
// a_ij = fma(-l_i, a_kj, a_ij)); the row swaps applied to b; then both
// triangular solves by blocks of rows from the top: within a block column
// by column (b_i -= b_k a_ik fused; the upper solve from the bottom, each
// b_k first divided by a_kk), then every row beyond the block less the
// block's dot product, summed with fused multiply-adds in ascending order.
// Blocks of TRSM_NB rows; a system of at most TRSM_WHOLE rows is one block
// (the probe: n = 18 one block, n = 24 to 48 blocks of 8).
//
// Who does it. The LU (lu_factor) is the whole block's: every warp finds
// the pivot itself (the same one), a swap relabels rows (sh.perm) instead
// of moving them, the trailing update's elements are spread over all the
// block's threads, and a step's multipliers are written during the next
// step's pivot search (no later step reads them). The triangular solves
// (lu_solve) are warp 0's, each row block's chain in registers and
// shuffles. Each element still sees the same operations in the same
// order. The rows' stride LDA is odd, so 32 lanes reading a column hit
// distinct banks. x is left in sh.y.
constexpr int TRSM_NB = 8;
constexpr int TRSM_WHOLE = 18;

__device__ void lu_factor(Shared& sh, int n) {
  const int lane = threadIdx.x & 31;
  BA_SOLVE_CLOCK(0);
  for (int i = threadIdx.x; i < n; i += THREADS) sh.perm[i] = i;
  __syncthreads();
  double rcp = 0.0;   // the last step's reciprocal
  // steps 0..5 (the gauge-fixed identity columns) leave every bit: skipped
  for (int k = 6; k < n; ++k) {
    // the last step's multipliers l_i = a_ik x rcp (rows below it: the same
    // physical rows whatever this step relabels)
    if (k > 6) {
      for (int i = k + threadIdx.x; i < n; i += THREADS) {
        double* row = sh.a[sh.perm[i]];
        row[k - 1] = __dmul_rn(row[k - 1], rcp);
      }
    }
    // pivot: the first row of largest |a_ik|, i >= k, a NaN never winning,
    // found by every warp alike. Each lane's first largest as a key (the
    // bits of |a_ik|, which order as the values do, plus 1; 0 for none or
    // a NaN), then the warp's largest key, high word then low word, and
    // the first row holding it
    unsigned long long best = 0ull;
    int p = n;
    for (int i = k + lane; i < n; i += 32) {
      const double v = fabs(sh.a[sh.perm[i]][k]);
      const unsigned long long key =
          isnan(v) ? 0ull
                   : static_cast<unsigned long long>(__double_as_longlong(v)) + 1ull;
      if (key > best) {
        best = key;
        p = i;
      }
    }
    const unsigned hi = static_cast<unsigned>(best >> 32);
    const unsigned lo = static_cast<unsigned>(best);
    const unsigned top = __reduce_max_sync(FULL, hi);
    const unsigned low = __reduce_max_sync(FULL, hi == top ? lo : 0u);
    p = static_cast<int>(__reduce_min_sync(
        FULL, hi == top && lo == low ? static_cast<unsigned>(p) : ~0u));
    const int rk = sh.perm[k];
    if (p == n || isnan(sh.a[rk][k])) p = k;
    const int rp = sh.perm[p];
    BA_SOLVE_CLOCK(1);
    __syncthreads();   // every read of perm done
    // logical rows k and p swapped: rows below k read perm, but row p as rk
    if (threadIdx.x == 0) {
      sh.perm[p] = rk;
      sh.perm[k] = rp;
    }
    const double* piv = sh.a[rp];
    rcp = __ddiv_rn(1.0, piv[k]);
    BA_SOLVE_CLOCK(2);
    // the trailing (r x r) block, element e = (k + 1 + e / r, k + 1 + e % r)
    // on thread e % THREADS: a_ij = fma(-l_i, a_kj, a_ij), l_i = a_ik x rcp
    const int r = n - k - 1;
    for (int e = threadIdx.x; e < r * r; e += THREADS) {
      const int i = k + 1 + e / r, j = k + 1 + e % r;
      double* row = sh.a[i == p ? rk : sh.perm[i]];
      row[j] = __fma_rn(-__dmul_rn(row[k], rcp), piv[j], row[j]);
    }
    BA_SOLVE_CLOCK(3);
    __syncthreads();
    BA_SOLVE_CLOCK(4);
  }
  // (the last step, k = n - 1, has no rows below it)
}

// The triangular solves of lu_factor's factors, by warp 0 (lane = its
// lane): x is left in sh.y.
__device__ void lu_solve(Shared& sh, int n, int lane) {
  for (int i = lane; i < n; i += 32) sh.y[i] = sh.b[sh.perm[i]];
  __syncwarp();
  const int nb = n <= TRSM_WHOLE ? n : TRSM_NB;
  // The triangular solves, each block's rows on lanes 0 .. nb - 1 (lane t
  // row bs + t, its y in a register, y_k from lane k - bs by a shuffle),
  // then the rows beyond the block on all lanes.
  // The unit lower solve, blocks from the top: within a block, at column k
  // every later row's y_i = fma(-y_k, l_ik, y_i)
  for (int bs = 0; bs < n; bs += nb) {
    const int be = min(n, bs + nb), t = bs + lane;
    const double* row = sh.a[sh.perm[t < be ? t : bs]];
    double yv = t < be ? sh.y[t] : 0.0;
    for (int k = bs; k < be - 1; ++k) {
      const double yk = __shfl_sync(FULL, yv, k - bs);
      if (t > k && t < be) yv = __fma_rn(-yk, row[k], yv);
    }
    if (t < be) sh.y[t] = yv;
    __syncwarp();
    for (int i = be + lane; i < n; i += 32) {
      const double* ri = sh.a[sh.perm[i]];
      double d = 0.0;
      for (int k = bs; k < be; ++k) d = __fma_rn(ri[k], sh.y[k], d);
      sh.y[i] = __dsub_rn(sh.y[i], d);
    }
    __syncwarp();
  }
  BA_SOLVE_CLOCK(5);
  // the upper solve, the same blocks from the last: within a block, from
  // its last row, y_k = y_k / u_kk, then every earlier row's y_i =
  // fma(-y_k, u_ik, y_i)
  for (int bs = (n - 1) / nb * nb; bs >= 0; bs -= nb) {
    const int be = min(n, bs + nb), t = bs + lane;
    const double* row = sh.a[sh.perm[t < be ? t : bs]];
    double yv = t < be ? sh.y[t] : 0.0;
    for (int k = be - 1; k >= bs; --k) {
      if (t == k) yv = __ddiv_rn(yv, row[k]);
      const double yk = __shfl_sync(FULL, yv, k - bs);
      if (t >= bs && t < k) yv = __fma_rn(-yk, row[k], yv);
    }
    if (t < be) sh.y[t] = yv;
    __syncwarp();
    for (int i = lane; i < bs; i += 32) {
      const double* ri = sh.a[sh.perm[i]];
      double d = 0.0;
      for (int k = bs; k < be; ++k) d = __fma_rn(ri[k], sh.y[k], d);
      sh.y[i] = __dsub_rn(sh.y[i], d);
    }
    __syncwarp();
  }
  BA_SOLVE_CLOCK(6);
}

// ---- the sums over the block's points (warp tasks)

// The Schur term S[f, g] = sum_m (h_cp h_pp^-1)[f, m] h_cp[g, m]^T over
// the points [lo, hi): 36 partials into out
__device__ void task_schur(const Scratch& s, int lo, int hi, int m, int f,
                           int g, int lane, double* out) {
  double acc[SCHUR];
#pragma unroll
  for (int o = 0; o < SCHUR; ++o) acc[o] = 0.0;
  const float* a = s.a + static_cast<long long>(f) * CP * m;
  const float* hc = s.hcp + static_cast<long long>(g) * CP * m;
  for (int p = lo + lane; p < hi; p += 32) {
    float hb[CP], ab[CP];
#pragma unroll
    for (int q = 0; q < CP; ++q) hb[q] = hc[static_cast<long long>(q) * m + p];
#pragma unroll
    for (int q = 0; q < CP; ++q) ab[q] = a[static_cast<long long>(q) * m + p];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        double t = __fma_rn(ab[3 * i], hb[3 * j], acc[6 * i + j]);
        t = __fma_rn(ab[3 * i + 1], hb[3 * j + 1], t);
        acc[6 * i + j] = __fma_rn(ab[3 * i + 2], hb[3 * j + 2], t);
      }
    }
  }
  fold<0, 32>(acc, lane);
  fold<32, 4>(acc, lane);
  out[lane] = acc[0];
  if ((lane & 7) == 0) out[32 + (lane >> 3)] = acc[32];
}

// h_cc's block and g_c's (camera b, pose f) over the points [lo, hi): 36 +
// 6 partials of sum_k jc_w[k]_i jc[k]_j and sum_k jc_w[k]_i r_k, jc_w = jc
// wr, into out
__device__ void task_camera(const Window& in, const Scratch& s, int lo,
                            int hi, int m, int f_dim, int b, int f,
                            float x_off, const Cam& c, int lane,
                            const Shared& sh, double* out) {
  double acc[CAM];
#pragma unroll
  for (int o = 0; o < CAM; ++o) acc[o] = 0.0;
  const float* pts = s.pts[sh.cur];
  const float* wg = s.wg + static_cast<long long>(b * f_dim + f) * m;
  for (int p = lo + lane; p < hi; p += 32) {
    const long long o = static_cast<long long>(f) * m + p;
    const Obs ob = observe(sh.r[f], sh.t[f], pts[p], pts[m + p],
                           pts[2 * m + p], in.obs[b][2 * o],
                           in.obs[b][2 * o + 1], wg[p], b, x_off, c);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float jw0 = __fmul_rn(ob.jc[0][i], ob.wr);
      const float jw1 = __fmul_rn(ob.jc[1][i], ob.wr);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const double t = __fma_rn(jw0, ob.jc[0][j], acc[6 * i + j]);
        acc[6 * i + j] = __fma_rn(jw1, ob.jc[1][j], t);
      }
      const double t = __fma_rn(jw0, ob.rx, acc[36 + i]);
      acc[36 + i] = __fma_rn(jw1, ob.ry, t);
    }
  }
  fold<0, 32>(acc, lane);
  fold<32, 8>(acc, lane);
  fold<40, 2>(acc, lane);
  out[lane] = acc[0];
  if ((lane & 3) == 0) out[32 + (lane >> 2)] = acc[32];
  if ((lane & 15) == 0) out[40 + (lane >> 4)] = acc[40];
}

// g_red's Schur term of pose f over the points [lo, hi): sum_m (h_cp
// h_pp^-1)[f, m] g_p[m], 6 partials into out
__device__ void task_gred(const Scratch& s, int lo, int hi, int m, int f,
                          int lane, double* out) {
  double acc[6];
#pragma unroll
  for (int o = 0; o < 6; ++o) acc[o] = 0.0;
  const float* a = s.a + static_cast<long long>(f) * CP * m;
#pragma unroll 4
  for (int p = lo + lane; p < hi; p += 32) {
    const float g0 = s.gp[p], g1 = s.gp[m + p], g2 = s.gp[2 * m + p];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      double t = __fma_rn(a[static_cast<long long>(3 * i) * m + p], g0, acc[i]);
      t = __fma_rn(a[static_cast<long long>(3 * i + 1) * m + p], g1, t);
      acc[i] = __fma_rn(a[static_cast<long long>(3 * i + 2) * m + p], g2, t);
    }
  }
  fold<0, 4>(acc, lane);
  fold<4, 2>(acc, lane);
  if ((lane & 7) == 0) out[lane >> 3] = acc[0];
  if ((lane & 15) == 0) out[4 + (lane >> 4)] = acc[4];
}

// ---- the steps of one iteration

// (1) per point of [lo, hi): h_cp [F, 6, 3] (each block's float64 sum over
// the two Jacobian rows rounded, the blocks added in float32), h_pp and g_p
// (each block's float64 sum over the poses and rows rounded, then added),
// h_pp^-1 = _inv33(h_pp, lambda), and h_cp h_pp^-1 for the poses that are
// not fixed. Lanes 2q and 2q + 1 share a point: each observes its own
// block (left on the even lane, right on the odd), they trade the rounded
// terms by a shuffle and add them in block order, and each writes rows
// 3b .. 3b + 2 of h_cp and of h_cp h_pp^-1 (b its lane's parity).
__device__ void point_blocks(const Window& in, const Scratch& s, int lo,
                             int hi, int m, int f_dim, float x_off,
                             const Cam& c, const Shared& sh) {
  const float* pts = s.pts[sh.cur];
  const float lam = sh.lam;
  const int b = threadIdx.x & 1;
  // warp-uniform rounds (the shuffles need every lane): 16 points a warp
  for (int base = lo + (threadIdx.x >> 5) * 16; base < hi;
       base += THREADS / 2) {
    const int pt = base + ((threadIdx.x & 31) >> 1);
    const bool on = pt < hi;
    const int p = on ? pt : base;
    const float x = pts[p], y = pts[m + p], z = pts[2 * m + p];
    // this block's h_pp (00 01 02 11 12 22) and g_p float64 sums over the
    // poses
    double ah[6] = {}, ag[3] = {};
    for (int f = 0; f < f_dim; ++f) {
      const long long o = static_cast<long long>(f) * m + p;
      const Obs ob = observe(sh.r[f], sh.t[f], x, y, z, in.obs[b][2 * o],
                             in.obs[b][2 * o + 1],
                             s.wg[static_cast<long long>(b) * f_dim * m + o],
                             b, x_off, c);
      float hcp[CP];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float jw0 = __fmul_rn(ob.jc[0][i], ob.wr);
        const float jw1 = __fmul_rn(ob.jc[1][i], ob.wr);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float mine = __double2float_rn(
              __fma_rn(jw1, ob.jp[1][j], __dmul_rn(jw0, ob.jp[0][j])));
          const float other = __shfl_xor_sync(FULL, mine, 1);
          hcp[3 * i + j] = __fadd_rn(__fadd_rn(0.0f, b == 0 ? mine : other),
                                     b == 0 ? other : mine);
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
          ah[o6] = __dadd_rn(ah[o6], __dmul_rn(t, wr));
        }
        const double t = __fma_rn(ob.jp[1][i], ob.ry,
                                  __dmul_rn(ob.jp[0][i], ob.rx));
        ag[i] = __dadd_rn(ag[i], __dmul_rn(t, wr));
      }
      if (on) {
        float* dst = s.hcp + static_cast<long long>(f) * CP * m + p;
        if (b == 0) {
#pragma unroll
          for (int q = 0; q < 9; ++q) dst[static_cast<long long>(q) * m] = hcp[q];
        } else {
#pragma unroll
          for (int q = 9; q < CP; ++q) dst[static_cast<long long>(q) * m] = hcp[q];
        }
      }
    }
    float hpp[6], gp[3];
#pragma unroll
    for (int o6 = 0; o6 < 6; ++o6) {
      const float mine = __double2float_rn(ah[o6]);
      const float other = __shfl_xor_sync(FULL, mine, 1);
      hpp[o6] = __fadd_rn(__fadd_rn(0.0f, b == 0 ? mine : other),
                          b == 0 ? other : mine);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float mine = __double2float_rn(ag[i]);
      const float other = __shfl_xor_sync(FULL, mine, 1);
      gp[i] = __fadd_rn(__fadd_rn(0.0f, b == 0 ? mine : other),
                        b == 0 ? other : mine);
    }
    if (!on) continue;
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
    for (int q = 0; q < 9; ++q) hinv[q] = __fmul_rn(cof[q], inv_det);
    if (b == 0) {
#pragma unroll
      for (int q = 0; q < 9; ++q) s.hinv[static_cast<long long>(q) * m + p] = hinv[q];
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i)
        s.gp[static_cast<long long>(i) * m + p] = gp[i];
    }
    // h_cp h_pp^-1: [6, 3] x [3, 3] per pose, float64 sums rounded once;
    // rows 3b .. 3b + 2, of the h_cp rows this lane wrote
    for (int f = 1; f < f_dim; ++f) {
      const float* hcp = s.hcp + (static_cast<long long>(f) * CP + 9 * b) * m + p;
      float* a = s.a + (static_cast<long long>(f) * CP + 9 * b) * m + p;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
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

// (3) the exchange: the reduced system in float32 as bundle.py builds it,
// from the totals of the iteration's sums (total(off): the sum at offset
// off of the iteration's layout, rounded once), widened: S = -Schur, plus
// (h_cc + lam I) on the diagonal blocks; g_red = g_c - Schur term; the
// fixed pose's rows and columns the identity, its right-hand side zero;
// b = -g_red
template <class Total>
__device__ void assemble(int f_dim, Shared& sh, Total total) {
  const int n = 6 * f_dim, nf = f_dim - 1;
  const float lam = sh.lam;
  for (int e = threadIdx.x; e < n * n; e += THREADS) {
    const int r = e / n, c = e % n;
    float v;
    if (r < 6 || c < 6) {
      v = r == c ? 1.0f : 0.0f;
    } else {
      const int f = r / 6, i = r % 6, g = c / 6, j = c % 6;
      const int o = 6 * i + j;
      v = -total(schur_at(f, g, nf) + o);
      if (f == g) {
        const float hcc = __fadd_rn(
            __fadd_rn(0.0f, total(cam_at(0, f, nf) + o)),
            total(cam_at(1, f, nf) + o));
        v = __fadd_rn(v, __fadd_rn(hcc, __fmul_rn(lam, i == j ? 1.0f : 0.0f)));
      }
    }
    sh.a[r][c] = v;
  }
  for (int r = threadIdx.x; r < n; r += THREADS) {
    const int f = r / 6, i = r % 6;
    float g = 0.0f;
    if (r >= 6) {
      const int o = 36 + i;
      const float gc = __fadd_rn(
          __fadd_rn(0.0f, total(cam_at(0, f, nf) + o)),
          total(cam_at(1, f, nf) + o));
      g = __fsub_rn(gc, total(gred_at(f, nf) + i));
    }
    sh.b[r] = -g;
  }
}

// (5) per point of [lo, hi): dp = -h_pp^-1 (g_p + sum_f h_cp[f]^T dc_f)
// and the trial position; returns whether a dp of the thread's points is
// not finite
__device__ bool point_steps(const Scratch& s, int lo, int hi, int m,
                            int f_dim, const Shared& sh) {
  const float* pts = s.pts[sh.cur];
  float* trial = s.pts[1 - sh.cur];
  bool bad = false;
  for (int p = lo + threadIdx.x; p < hi; p += THREADS) {
    // per j, sum_f sum_i h_cp[f]_ij dc_fi in that order; a pose's 18
    // values of h_cp loaded at once
    double acc[3] = {0.0, 0.0, 0.0};
    for (int f = 0; f < f_dim; ++f) {
      const float* hcp = s.hcp + static_cast<long long>(f) * CP * m + p;
      float h[CP];
#pragma unroll
      for (int q = 0; q < CP; ++q) h[q] = hcp[static_cast<long long>(q) * m];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
#pragma unroll
        for (int i = 0; i < 6; ++i)
          acc[j] = __fma_rn(h[3 * i + j], sh.dc[6 * f + i], acc[j]);
      }
    }
    float t[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      t[j] = __fadd_rn(s.gp[static_cast<long long>(j) * m + p],
                       __double2float_rn(acc[j]));
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
  return bad;
}

// (6) the robust chi-square's two blocks at the poses (r, t) and the
// positions pts over the points [lo, hi), float64 sums of float32 terms,
// into v[0..1] (zero before); lanes 2q and 2q + 1 share a point, the even
// one summing the left block, the odd one the right
__device__ void robust_chi2(const Window& in, const Scratch& s, int lo,
                            int hi, int m, int f_dim, float x_off,
                            const Cam& c, const float (*r)[9],
                            const float (*t)[3], const float* pts,
                            double (&v)[3]) {
  const int b = threadIdx.x & 1;
  const float* wg = s.wg + static_cast<long long>(b) * f_dim * m;
  double acc = 0.0;
  for (int p = lo + (threadIdx.x >> 1); p < hi; p += THREADS / 2) {
    const float x = pts[p], y = pts[m + p], z = pts[2 * m + p];
    for (int f = 0; f < f_dim; ++f) {
      const long long o = static_cast<long long>(f) * m + p;
      float lx, ly, lz;
      camera_point(r[f], t[f], x, y, z, lx, ly, lz);
      const Proj pr = project_cam(b == 0 ? lx : __fadd_rn(lx, x_off), ly, lz,
                                  in.obs[b][2 * o], in.obs[b][2 * o + 1], c);
      acc = __dadd_rn(acc, static_cast<double>(rho(wg[o], pr.e2, c)));
    }
  }
  v[0] = b == 0 ? acc : 0.0;
  v[1] = b == 0 ? 0.0 : acc;
}

// the total of the robust chi-square's two blocks, each rounded once
__device__ float chi2_total(double left, double right) {
  return __fadd_rn(__fadd_rn(0.0f, __double2float_rn(left)),
                   __double2float_rn(right));
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

// ---- the body's parts, shared by ba_refine_kernel (the whole body in one
// launch) and ba_phase_kernel (the body split at its sums over the points)

// The window's poses world to camera, original and current alike (the
// trial ones zero), the newest pose's position, lambda and nu at their
// start; then a barrier
__device__ void init_state(const Window& in, int f_dim, Shared& sh) {
  if (threadIdx.x < f_dim) {
    const int f = threadIdx.x;
    world_to_camera(in.t + 3 * f, in.q + 4 * f, sh.r0[f], sh.t0[f]);
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      sh.r[f][i] = sh.r0[f][i];
      sh.rt[f][i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      sh.t[f][i] = sh.t0[f][i];
      sh.tt[f][i] = 0.0f;
    }
    if (f == f_dim - 1) {
#pragma unroll
      for (int i = 0; i < 3; ++i) sh.tn[i] = in.t[3 * f + i];
    }
  }
  if (threadIdx.x == 0) {
    sh.cur = 0;
    sh.lam = 1e-4f;
    sh.nu = 2.0f;
    sh.chi2 = 0.0f;
    sh.gate = 0.0f;
    sh.bad = 0;
    sh.n_obs = 0.0f;
  }
  __syncthreads();
}

// The gated weights (the gate sh.gate), `use`, the positions, and the fit
// at the original state, of the block's points [lo, hi); returns the
// thread's count of observations with a positive weight
__device__ int setup_points(const Window& in, const Scratch& s, int lo,
                            int hi, int f_dim, int m, float x_off,
                            const Cam& cam, const Shared& sh) {
  int n_obs = 0;
  for (int p = lo + threadIdx.x; p < hi; p += THREADS) {
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
  for (int p = lo + threadIdx.x; p < hi; p += THREADS) {
    s.e2_old[p] = point_e2(in, s, m, f_dim, p, in.pos[3 * p],
                           in.pos[3 * p + 1], in.pos[3 * p + 2], x_off, cam, sh);
  }
  return n_obs;
}

// This block's partials of an iteration's sums over the points, of the
// free poses f, g >= 1: Schur blocks (f, g), camera blocks (b, f), g_red's
// terms (f), each task's at schur_at, cam_at or gred_at of sh.iter
__device__ void block_partials(const Window& in, const Scratch& s, int lo,
                               int hi, int m, int f_dim, float x_off,
                               const Cam& cam, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nf = f_dim - 1, n_schur = nf * nf, n_cam = NB * nf;
  for (int task = warp; task < n_schur + n_cam + nf; task += WARPS) {
    if (task < n_schur) {
      const int f = 1 + task / nf, g = 1 + task % nf;
      task_schur(s, lo, hi, m, f, g, lane, sh.iter + schur_at(f, g, nf));
    } else if (task < n_schur + n_cam) {
      const int b = (task - n_schur) / nf, f = 1 + (task - n_schur) % nf;
      task_camera(in, s, lo, hi, m, f_dim, b, f, x_off, cam, lane, sh,
                  sh.iter + cam_at(b, f, nf));
    } else {
      const int f = 1 + task - n_schur - n_cam;
      task_gred(s, lo, hi, m, f, lane, sh.iter + gred_at(f, nf));
    }
  }
}

// (4) the reduced system's solve: dc into sh.dc, sh.bad set where it is not
// finite; then a barrier
__device__ void camera_solve(Shared& sh, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  lu_factor(sh, n);
  if (warp == 0) {
    lu_solve(sh, n, lane);
    for (int r = lane; r < n; r += 32) {
      sh.dc[r] = __double2float_rn(sh.y[r]);
      if (!isfinite(sh.dc[r])) sh.bad = 1;
    }
  }
  __syncthreads();
}

// (5)-(6) the trial: the poses retracted by dc, the points' steps and trial
// positions, then the robust chi-square's two blocks at the trial state
// into v[0..1] and whether a dp of the thread's points is not finite into
// v[2]
__device__ void trial_sums(const Window& in, const Scratch& s, int lo,
                           int hi, int m, int f_dim, float x_off,
                           const Cam& cam, Shared& sh, double (&v)[3]) {
  if (threadIdx.x < f_dim) {
    const int f = threadIdx.x;
    retract(sh.r[f], sh.t[f], sh.dc + 6 * f, sh.rt[f], sh.tt[f]);
  }
  const bool bad_dp = point_steps(s, lo, hi, m, f_dim, sh);
  __syncthreads();
  v[0] = v[1] = 0.0;
  v[2] = bad_dp ? 1.0 : 0.0;
  robust_chi2(in, s, lo, hi, m, f_dim, x_off, cam, sh.rt, sh.tt,
              s.pts[1 - sh.cur], v);
}

// The accept test's outcome (by one thread): a step whose chi-square falls
// and that is finite (`finite`) takes the trial state, and lambda falls;
// else the state stays and lambda rises. Returns whether it was taken
__device__ bool accept(Shared& sh, float chi2_new, bool finite,
                       int f_dim) {
  const bool ok = chi2_new < sh.chi2 && finite;
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
  return ok;
}

// The writeback of the block's points [lo, hi) into out [M, 3]: a refined
// point is kept where it takes part, stays within 10% of its distance to
// the newest camera + 0.5 m, and fits the gated observations at the
// original poses no worse than before
__device__ void writeback(const Window& in, const Scratch& s, int lo, int hi,
                          int m, int f_dim, float x_off, const Cam& cam,
                          const Shared& sh, float* out) {
  const float* pts = s.pts[sh.cur];
  for (int p = lo + threadIdx.x; p < hi; p += THREADS) {
    const float x0 = in.pos[3 * p], y0 = in.pos[3 * p + 1], z0 = in.pos[3 * p + 2];
    const float x = pts[p], y = pts[m + p], z = pts[2 * m + p];
    const float dist = norm3(__fsub_rn(x0, sh.tn[0]), __fsub_rn(y0, sh.tn[1]),
                             __fsub_rn(z0, sh.tn[2]));
    const float step = norm3(__fsub_rn(x, x0), __fsub_rn(y, y0), __fsub_rn(z, z0));
    bool ok = s.use[p] > 0.0f &&
              step <= __fadd_rn(__fmul_rn(0.1f, dist), 0.5f);
    ok = ok && point_e2(in, s, m, f_dim, p, x, y, z, x_off, cam, sh) <=
                   s.e2_old[p];
    out[3 * p] = ok ? x : x0;
    out[3 * p + 1] = ok ? y : y0;
    out[3 * p + 2] = ok ? z : z0;
  }
}

// one stream's window in the launch's arrays
__device__ __forceinline__ Window window_of(
    long long st, int f_dim, int m, const float* t_in, const float* q_in,
    const float* pos_in, const float* obs_l, const float* w_l,
    const float* obs_r, const float* w_r) {
  const long long fm = static_cast<long long>(f_dim) * m;
  return Window{t_in + st * f_dim * 3, q_in + st * f_dim * 4,
                pos_in + st * m * 3, {obs_l + st * fm * 2, obs_r + st * fm * 2},
                {w_l + st * fm, w_r + st * fm}};
}

// ---- the whole body: one cluster per stream

__global__ void __cluster_dims__(CLUSTER, 1, 1)
    __launch_bounds__(THREADS, 1) ba_refine_kernel(
        const float* __restrict__ t_in, const float* __restrict__ q_in,
        const float* __restrict__ pos_in, const float* __restrict__ obs_l,
        const float* __restrict__ w_l, const float* __restrict__ obs_r,
        const float* __restrict__ w_r, int f_dim, int m, int iters, Cam cam,
        float x_off, float gate_th2, float* __restrict__ scratch,
        float* __restrict__ pos_out, float* __restrict__ chi2_out,
        long long* __restrict__ n_obs_out,
        unsigned char* __restrict__ accepted) {
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long st = blockIdx.x / CLUSTER;
  const Window in = window_of(st, f_dim, m, t_in, q_in, pos_in, obs_l, w_l,
                              obs_r, w_r);
  const Scratch s(scratch + st * scratch_per_point(f_dim) * m, f_dim, m);
  // this block's points
  const int lo = static_cast<int>(static_cast<long long>(rank) * m / CLUSTER);
  const int hi =
      static_cast<int>(static_cast<long long>(rank + 1) * m / CLUSTER);
  int par = 0;   // cluster_sum's buffer
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_launches, 1ull);
  BA_PHASE_CLOCK(0);

  init_state(in, f_dim, sh);

  // the gate: gate = max(gate_th2, 3 x the mean e2 of the observations
  // with e2 <= 4 x the plain mean)
  {
    double v[4] = {0.0, 0.0, 0.0, 0.0};
    gate_moments(in, lo, hi, f_dim, m, x_off, cam, false, 0.0f, sh, v);
    cluster_sum(v, sh, par);
  }
  if (threadIdx.x == 0) sh.gate = __fmul_rn(4.0f, mean_e2(sh.sums));
  __syncthreads();
  {
    double v[4] = {0.0, 0.0, 0.0, 0.0};
    gate_moments(in, lo, hi, f_dim, m, x_off, cam, true, sh.gate, sh, v);
    cluster_sum(v, sh, par);
  }
  if (threadIdx.x == 0)
    sh.gate = clamp_min(__fmul_rn(3.0f, mean_e2(sh.sums)), gate_th2);
  __syncthreads();

  // the gated weights, `use`, the positions, and the fit at the original
  // state; the observation count
  const int n_obs = setup_points(in, s, lo, hi, f_dim, m, x_off, cam, sh);
  {
    // the chi-square at the start, and the count (exact in float64)
    double v[3] = {0.0, 0.0, static_cast<double>(n_obs)};
    robust_chi2(in, s, lo, hi, m, f_dim, x_off, cam, sh.r0, sh.t0, s.pts[0], v);
    cluster_sum(v, sh, par);
  }
  if (threadIdx.x == 0) {
    sh.chi2 = chi2_total(sh.sums[0], sh.sums[1]);
    if (rank == 0) n_obs_out[st] = static_cast<long long>(sh.sums[2]);
  }
  __syncthreads();
  BA_PHASE_CLOCK(1);

  const int n = 6 * f_dim;
  for (int it = 0; it < iters; ++it) {
    point_blocks(in, s, lo, hi, m, f_dim, x_off, cam, sh);
    if (threadIdx.x == 0) sh.bad = 0;
    __syncthreads();
    BA_PHASE_CLOCK(2 + 6 * it);
    block_partials(in, s, lo, hi, m, f_dim, x_off, cam, sh);
    BA_PHASE_CLOCK(3 + 6 * it);
    // every block's partials written; the last iteration's were read by
    // every block before the trial's cluster_sum
    cluster.sync();
    assemble(f_dim, sh, [&](int off) { return iter_total(cluster, sh, off); });
    __syncthreads();
    BA_PHASE_CLOCK(4 + 6 * it);
    camera_solve(sh, n);
    BA_PHASE_CLOCK(5 + 6 * it);
    // the trial's chi-square, and the count of non-finite dp
    double v[3];
    trial_sums(in, s, lo, hi, m, f_dim, x_off, cam, sh, v);
    BA_PHASE_CLOCK(6 + 6 * it);
    cluster_sum(v, sh, par);
    if (threadIdx.x == 0) {
      const bool ok = accept(sh, chi2_total(sh.sums[0], sh.sums[1]),
                             sh.bad == 0 && sh.sums[2] == 0.0, f_dim);
      if (rank == 0) accepted[st * iters + it] = ok;
    }
    __syncthreads();
    BA_PHASE_CLOCK(7 + 6 * it);
  }

  writeback(in, s, lo, hi, m, f_dim, x_off, cam, sh, pos_out + st * m * 3);
  if (rank == 0 && threadIdx.x == 0) chi2_out[st] = sh.chi2;
  BA_PHASE_CLOCK(2 + 6 * iters);
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

// ---- the body split at its sums over the points: one launch per phase

// ba_phase_kernel's launches on this device since the library was loaded
// (as g_launches)
__device__ unsigned long long g_phase_launches;

// The phases, in launch order (solver/bundle.py's K_*): the gate's first
// moments; its second ones; the gated weights, the fit at the original
// state and the first chi-square with the observation count; per LM
// iteration its sums, then its trial step; then the last accept test and
// the writeback
enum : int { K_GATE1, K_GATE2, K_SETUP, K_SUMS, K_TRIAL, K_FINAL };

// A stream's state row between the phases, floats (bundle.py's
// state_size): the poses world to camera (original, current, trial; 9 + 3
// each), the newest pose's position, lambda, nu, chi2, the gate, which of
// Scratch::pts is current, whether the trial step was not finite (dc, or
// a dp of this rank's points), the observation count, then the accept
// bits
constexpr int ST_SCALARS = 7;
__host__ __device__ constexpr int state_size(int f_dim, int iters) {
  return 36 * f_dim + 3 + ST_SCALARS + iters;
}
__host__ __device__ constexpr int iter_sums(int f_dim) {
  return SCHUR * (f_dim - 1) * (f_dim - 1) + NB * CAM * (f_dim - 1) +
         GRED * (f_dim - 1);
}
// the float64 partials a phase writes per stream
__host__ __device__ constexpr int part_size(int kind, int f_dim) {
  return kind == K_GATE1 || kind == K_GATE2 ? 4
         : kind == K_SETUP                  ? 3
         : kind == K_SUMS                   ? iter_sums(f_dim)
         : kind == K_TRIAL                  ? 2
                                            : 0;
}
// ... and the all-reduced ones it reads (the previous phase's)
__host__ __device__ constexpr int tot_size(int kind, int it, int f_dim) {
  return kind == K_GATE1                      ? 0
         : kind == K_GATE2 || kind == K_SETUP ? 4
         : kind == K_TRIAL                    ? iter_sums(f_dim)
         : it == 0                            ? 3
                                              : 2;
}

__device__ void load_state(const float* row, int f_dim, Shared& sh) {
  for (int e = threadIdx.x; e < 36 * f_dim + 3; e += THREADS) {
    const int field = e / (12 * f_dim) * 2 + (e % (12 * f_dim)) / (9 * f_dim);
    const int at = e % (12 * f_dim);
    if (e >= 36 * f_dim) {
      sh.tn[e - 36 * f_dim] = row[e];
    } else if (at < 9 * f_dim) {
      float(*r)[9] = field == 0 ? sh.r0 : field == 2 ? sh.r : sh.rt;
      r[at / 9][at % 9] = row[e];
    } else {
      float(*t)[3] = field == 1 ? sh.t0 : field == 3 ? sh.t : sh.tt;
      t[(at - 9 * f_dim) / 3][(at - 9 * f_dim) % 3] = row[e];
    }
  }
  if (threadIdx.x == 0) {
    const float* x = row + 36 * f_dim + 3;
    sh.lam = x[0];
    sh.nu = x[1];
    sh.chi2 = x[2];
    sh.gate = x[3];
    sh.cur = x[4] != 0.0f;
    sh.bad = x[5] != 0.0f;
    sh.n_obs = x[6];
  }
  __syncthreads();
}

// the state row from sh (by one block; the accept bits from `acc_in`,
// none for the first phase, with bit `slot` set to `ok` if slot >= 0)
__device__ void store_state(float* row, int f_dim, int iters, const Shared& sh,
                            const float* acc_in, int slot, bool ok) {
  for (int e = threadIdx.x; e < 36 * f_dim + 3; e += THREADS) {
    const int field = e / (12 * f_dim) * 2 + (e % (12 * f_dim)) / (9 * f_dim);
    const int at = e % (12 * f_dim);
    if (e >= 36 * f_dim) {
      row[e] = sh.tn[e - 36 * f_dim];
    } else if (at < 9 * f_dim) {
      const float(*r)[9] = field == 0 ? sh.r0 : field == 2 ? sh.r : sh.rt;
      row[e] = r[at / 9][at % 9];
    } else {
      const float(*t)[3] = field == 1 ? sh.t0 : field == 3 ? sh.t : sh.tt;
      row[e] = t[(at - 9 * f_dim) / 3][(at - 9 * f_dim) % 3];
    }
  }
  float* x = row + 36 * f_dim + 3;
  if (threadIdx.x == 0) {
    x[0] = sh.lam;
    x[1] = sh.nu;
    x[2] = sh.chi2;
    x[3] = sh.gate;
    x[4] = static_cast<float>(sh.cur);
    x[5] = static_cast<float>(sh.bad);
    x[6] = sh.n_obs;
  }
  for (int i = threadIdx.x; i < iters; i += THREADS) {
    const float prev = acc_in == nullptr ? 0.0f : acc_in[i];
    x[ST_SCALARS + i] = i == slot ? (ok ? 1.0f : 0.0f) : prev;
  }
}

// One phase of ba_refine_kernel's body for S streams, one cluster per
// stream and its blocks' slices of the points as there. Between the
// phases a stream's state row (state_in -> state_out) and scratch row
// (scratch_in -> scratch_out: K_SUMS and K_TRIAL copy their block's slice
// and work on the copy; K_SETUP writes a new one; K_FINAL reads it) carry
// what ba_refine_kernel keeps in shared memory and its scratch. A phase
// writes part [S, part_size], the cluster's float64 totals of its sums over
// the points (its blocks' partials added in rank order); the all-reduced
// totals come back as the next phase's tot [S, tot_size], rounded once
// there, so on one rank every sum is ba_refine_kernel's. The accept test
// of a trial runs at the start of the next K_SUMS or K_FINAL; a non-finite
// dp counts over this rank's points only (the plain group version's test).
// `it`: the LM iteration of K_SUMS and K_TRIAL; K_FINAL's is `iters`.
__global__ void __cluster_dims__(CLUSTER, 1, 1)
    __launch_bounds__(THREADS, 1) ba_phase_kernel(
        int kind, int it, const float* __restrict__ t_in,
        const float* __restrict__ q_in, const float* __restrict__ pos_in,
        const float* __restrict__ obs_l, const float* __restrict__ w_l,
        const float* __restrict__ obs_r, const float* __restrict__ w_r,
        int f_dim, int m, int iters, Cam cam, float x_off, float gate_th2,
        const float* __restrict__ state_in, float* __restrict__ state_out,
        const float* __restrict__ scratch_in, float* __restrict__ scratch_out,
        const double* __restrict__ tot, double* __restrict__ part,
        float* __restrict__ pos_out) {
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long st = blockIdx.x / CLUSTER;
  const Window in = window_of(st, f_dim, m, t_in, q_in, pos_in, obs_l, w_l,
                              obs_r, w_r);
  const int lo = static_cast<int>(static_cast<long long>(rank) * m / CLUSTER);
  const int hi =
      static_cast<int>(static_cast<long long>(rank + 1) * m / CLUSTER);
  const int ns = state_size(f_dim, iters), spp = scratch_per_point(f_dim);
  const float* row_in = state_in == nullptr ? nullptr : state_in + st * ns;
  float* row_out = state_out + st * ns;
  const double* sums_in = tot + st * tot_size(kind, it, f_dim);
  double* sums_out = part + st * part_size(kind, f_dim);
  int par = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_phase_launches, 1ull);

  if (kind == K_GATE1) {
    init_state(in, f_dim, sh);
  } else {
    load_state(row_in, f_dim, sh);
  }
  // the scratch row: K_SUMS and K_TRIAL work on a copy of their slice,
  // K_SUMS of the rows it reads before it writes the rest (the positions,
  // the gated weights, the old fit and the mask), K_TRIAL of all of them
  float* base = kind == K_FINAL
                    ? const_cast<float*>(scratch_in) + st * spp * m
                    : (kind >= K_SETUP ? scratch_out + st * spp * m : nullptr);
  const int rows = kind == K_SUMS ? 3 + 3 + NB * f_dim + 1 + 1
                   : kind == K_TRIAL ? spp
                                     : 0;
  if (rows > 0) {
    const float* src = scratch_in + st * spp * m;
    for (int r = 0; r < rows; ++r) {
      const long long row = static_cast<long long>(r) * m;
      for (int p = lo + threadIdx.x; p < hi; p += THREADS)
        base[row + p] = src[row + p];
    }
    __syncthreads();
  }
  const Scratch s(base, f_dim, m);

  if (kind == K_GATE1 || kind == K_GATE2) {
    // the second sweep keeps the observations with e2 <= 4 x the mean
    const float cut =
        kind == K_GATE2 ? __fmul_rn(4.0f, mean_e2(sums_in)) : 0.0f;
    double v[4] = {0.0, 0.0, 0.0, 0.0};
    gate_moments(in, lo, hi, f_dim, m, x_off, cam, kind == K_GATE2, cut, sh,
                 v);
    cluster_sum(v, sh, par);
    if (rank == 0 && threadIdx.x < 4) sums_out[threadIdx.x] = sh.sums[threadIdx.x];
  } else if (kind == K_SETUP) {
    if (threadIdx.x == 0)
      sh.gate = clamp_min(__fmul_rn(3.0f, mean_e2(sums_in)), gate_th2);
    __syncthreads();
    const int n_obs = setup_points(in, s, lo, hi, f_dim, m, x_off, cam, sh);
    double v[3] = {0.0, 0.0, static_cast<double>(n_obs)};
    robust_chi2(in, s, lo, hi, m, f_dim, x_off, cam, sh.r0, sh.t0, s.pts[0], v);
    cluster_sum(v, sh, par);
    if (rank == 0 && threadIdx.x < 3) sums_out[threadIdx.x] = sh.sums[threadIdx.x];
  }

  // K_SUMS and K_FINAL: the starting chi-square, or the last trial's accept
  // test (its chi-square all-reduced, its finiteness this rank's)
  int slot = -1;
  bool ok = false;
  if (kind == K_SUMS || kind == K_FINAL) {
    if (threadIdx.x == 0) {
      if (it == 0) {
        sh.chi2 = chi2_total(sums_in[0], sums_in[1]);
        sh.n_obs = static_cast<float>(sums_in[2]);
      } else {
        ok = accept(sh, chi2_total(sums_in[0], sums_in[1]), sh.bad == 0, f_dim);
      }
    }
    if (it > 0) slot = it - 1;
    __syncthreads();
  }
  if (kind == K_SUMS) {
    point_blocks(in, s, lo, hi, m, f_dim, x_off, cam, sh);
    __syncthreads();
    block_partials(in, s, lo, hi, m, f_dim, x_off, cam, sh);
    cluster.sync();
    // the cluster's totals, in rank order, a share of them by each block
    const int n_iter = iter_sums(f_dim);
    for (int e = rank * THREADS + threadIdx.x; e < n_iter;
         e += CLUSTER * THREADS) {
      double* mine = sh.iter + e;
      double x = *cluster.map_shared_rank(mine, 0);
#pragma unroll
      for (int r = 1; r < CLUSTER; ++r)
        x = __dadd_rn(x, *cluster.map_shared_rank(mine, r));
      sums_out[e] = x;
    }
  } else if (kind == K_TRIAL) {
    if (threadIdx.x == 0) sh.bad = 0;
    assemble(f_dim, sh, [&](int off) { return __double2float_rn(sums_in[off]); });
    __syncthreads();
    camera_solve(sh, 6 * f_dim);
    double v[3];
    trial_sums(in, s, lo, hi, m, f_dim, x_off, cam, sh, v);
    cluster_sum(v, sh, par);
    if (threadIdx.x == 0 && sh.sums[2] != 0.0) sh.bad = 1;
    if (rank == 0 && threadIdx.x < 2) sums_out[threadIdx.x] = sh.sums[threadIdx.x];
    __syncthreads();
  } else if (kind == K_FINAL) {
    writeback(in, s, lo, hi, m, f_dim, x_off, cam, sh, pos_out + st * m * 3);
  }
  // every block holds the same state: rank 0 writes it (the accept bit of
  // thread 0's test)
  if (rank == 0) {
    if (threadIdx.x == 0) sh.ok = ok;
    __syncthreads();
    store_state(row_out, f_dim, iters, sh,
                row_in == nullptr ? nullptr : row_in + 36 * f_dim + 3 + ST_SCALARS,
                slot, sh.ok);
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

}  // namespace

// S streams of local BA's body: window poses t [S, F, 3], q [S, F, 4], map
// positions [S, M, 3], observations obs_l, obs_r [S, F, M, 2] and weights
// w_l, w_r [S, F, M] float32; the camera, the right camera's x offset in
// the left frame (-baseline), the gate's floor, the LM iterations;
// scratch [S, M * lvt_ba_scratch_per_point(F)] float32; outputs pos [S, M, 3],
// chi2 [S] float32, n_obs [S] int64, accepted [S, iters] bool. One cluster
// of lvt_ba_geometry()'s blocks per stream; F <= lvt_ba_max_window().
extern "C" int lvt_ba_max_window() { return MAX_F; }

// The kernel's shape: blocks per stream (the cluster) and threads per
// block, into out[0..1]
extern "C" int lvt_ba_geometry(int* out) {
  out[0] = CLUSTER;
  out[1] = THREADS;
  return 0;
}

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
  if (CLUSTER > 8) {   // beyond the portable cluster size: asked for
    const cudaError_t err = cudaFuncSetAttribute(
        ba_refine_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_streams > 0) {
    ba_refine_kernel<<<n_streams * CLUSTER, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        t, q, pos, obs_l, w_l, obs_r, w_r, f_dim, m, iters,
        Cam{fx, fy, cx, cy, th2}, x_off, gate_th2, scratch, pos_out, chi2,
        n_obs, static_cast<unsigned char*>(accepted));
  }
  return static_cast<int>(cudaGetLastError());
}

// The phased body's layout for F poses and `iters` LM iterations, into
// out[0..2]: the state row's floats, the scratch's floats per point, an
// iteration's float64 sums (the wrapper checks them against its own)
extern "C" int lvt_ba_phase_shape(int f_dim, int iters, int* out) {
  out[0] = state_size(f_dim, iters);
  out[1] = scratch_per_point(f_dim);
  out[2] = iter_sums(f_dim);
  return 0;
}

// The launches of ba_phase_kernel on the current device so far
extern "C" int lvt_ba_phase_launches(long long* out) {
  unsigned long long n = 0;
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(&n, g_phase_launches, sizeof n);
  *out = static_cast<long long>(n);
  return static_cast<int>(err);
}

// One phase (kind, it) of S streams' sharded BA bodies (ba_phase_kernel):
// the window as lvt_ba_refine takes it; state_in [S, state_size] (null for
// K_GATE1), state_out [S, state_size]; scratch_in [S, M * scratch per
// point] (K_SUMS, K_TRIAL, K_FINAL), scratch_out (K_SETUP, K_SUMS,
// K_TRIAL); tot [S, tot_size] float64 (null for K_GATE1, and where it
// holds nothing), part [S, part_size] float64; pos_out [S, M, 3] (K_FINAL;
// the scratch and pos_out may be null where M = 0). One cluster of
// lvt_ba_geometry()'s blocks per stream; F <= lvt_ba_max_window().
extern "C" int lvt_ba_phase(int kind, int it, const float* t, const float* q,
                            const float* pos, const float* obs_l,
                            const float* w_l, const float* obs_r,
                            const float* w_r, int n_streams, int f_dim, int m,
                            int iters, float fx, float fy, float cx, float cy,
                            float th2, float x_off, float gate_th2,
                            const float* state_in, float* state_out,
                            const float* scratch_in, float* scratch_out,
                            const double* tot, double* part, float* pos_out,
                            void* stream) {
  const bool first = kind == K_GATE1;
  const bool reads = kind == K_SUMS || kind == K_TRIAL || kind == K_FINAL;
  const bool keeps = kind == K_SETUP || kind == K_SUMS || kind == K_TRIAL;
  if (f_dim < 1 || f_dim > MAX_F || m < 0 || iters < 0 || kind < K_GATE1 ||
      kind > K_FINAL || it < 0 ||
      (kind == K_FINAL ? it != iters
                       : (kind == K_SUMS || kind == K_TRIAL) && it >= iters) ||
      (!first && (state_in == nullptr ||
                  (tot == nullptr && tot_size(kind, it, f_dim) > 0))) ||
      state_out == nullptr || (m > 0 && reads && scratch_in == nullptr) ||
      (m > 0 && keeps && scratch_out == nullptr) ||
      (m > 0 && kind == K_FINAL && pos_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_streams > 0) {
    ba_phase_kernel<<<n_streams * CLUSTER, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        kind, it, t, q, pos, obs_l, w_l, obs_r, w_r, f_dim, m, iters,
        Cam{fx, fy, cx, cy, th2}, x_off, gate_th2, state_in, state_out,
        scratch_in, scratch_out, tot, part, pos_out);
  }
  return static_cast<int>(cudaGetLastError());
}
