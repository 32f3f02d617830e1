// PnP's reductions for Hopper, summed in an order that does not depend on
// how many streams share the launch: the normal equations
// (pnp_normal_eqs_kernel, in float64) and the robust chi-square's sum over
// the points (stream_sum_kernel, in float32).
//
// Computes, for each of S streams, the product lvt_tpu/solver/pnp.py:155-156
// forms with two XLA einsums inside every Levenberg-Marquardt iteration,
//   H = sum_m,k jw[m, k, :]^T jac[m, k, :]   [6, 6]
//   g = sum_m,k jw[m, k, :]^T r[m, k]        [6]
// with jw = jac * w[m], as one [6, 7] block hg = [H | g], and the diagonal
// of H (pnp.py:184's h_diag, the initial damping). It is not a TPU kernel:
// the port had these contractions as torch.einsum, which on the card sums
// a batched product (the multi-stream step under torch.func.vmap) in
// another order than a single one, so a stream of the batch drifted from
// the same stream tracked alone. Here one block owns one stream, and its
// sums run in an order fixed by M alone: thread t takes the points t,
// t + 256, t + 512, ... and accumulates its 42 products in that order;
// each warp then folds its 32 lanes with a fixed xor butterfly, and one
// thread per output adds the 8 warps' partial sums in warp order. A stream
// of an S-stream launch therefore gets the bits of its own S = 1 launch,
// whatever S. The diagonal comes from the same sums, so H's diagonal and
// h_diag are equal.
//
// The products are formed as the plain version forms them: jw = jac * w
// rounded to float32 first, then jw_i * x_j. They are summed in float64
// (the product of two float32 values is exact there) and each sum is
// rounded to float32 once. Why float64: g and H's off-diagonal entries sum
// terms of both signs that cancel (g is zero at the optimum, where the
// last LM steps are taken), so a float32 sum's error can be large against
// the result, and it would steer the step; in float64 the result is the
// exact sum rounded once, and its distance to any float32 order of
// summation, the CPU's included, is that order's own rounding.
//
// What bounds it on the card: 60 bytes per point read (12 Jacobian
// entries, a weight, 2 residuals), 12 float32 products and 84 float64
// fused multiply-adds per point: at the main path's 1024 points that is
// 60 KB and 98k instructions, well under a microsecond either way; one
// block per stream and the serial reduction set its time, and launch
// latency the rest. M has no upper bound: the point loop runs
// ceil(M / 256) times.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NP = 6;            // pose parameters: rows of hg
constexpr int NC = 7;            // the 6 Jacobian columns and the residual
constexpr int NOUT = NP * NC;    // 42
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS) pnp_normal_eqs_kernel(
    const float* __restrict__ jac, const float* __restrict__ w,
    const float* __restrict__ r, int m, float* __restrict__ hg,
    float* __restrict__ h_diag) {
  __shared__ double part[WARPS][NOUT];
  // this block's stream: its slices of every input and output
  const long long s = blockIdx.x;
  jac += s * m * 2 * NP;
  w += s * m;
  r += s * m * 2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  double acc[NOUT];
#pragma unroll
  for (int o = 0; o < NOUT; ++o) acc[o] = 0.0;

  for (int p = threadIdx.x; p < m; p += THREADS) {
    const float wp = w[p];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float* row = jac + (2 * p + k) * NP;
      float x[NC];
#pragma unroll
      for (int j = 0; j < NP; ++j) x[j] = row[j];
      x[NP] = r[2 * p + k];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const double jw = __fmul_rn(x[i], wp);
#pragma unroll
        for (int j = 0; j < NC; ++j)
          acc[i * NC + j] = __fma_rn(jw, static_cast<double>(x[j]),
                                     acc[i * NC + j]);
      }
    }
  }

#pragma unroll
  for (int o = 0; o < NOUT; ++o) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[o] = __dadd_rn(acc[o], __shfl_xor_sync(FULL, acc[o], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int o = 0; o < NOUT; ++o) part[warp][o] = acc[o];
  }
  __syncthreads();

  const int o = threadIdx.x;
  if (o >= NOUT) return;
  double sum = part[0][o];
#pragma unroll
  for (int q = 1; q < WARPS; ++q) sum = __dadd_rn(sum, part[q][o]);
  hg[s * NOUT + o] = __double2float_rn(sum);
  const int i = o / NC;
  if (o % NC == i) h_diag[s * NP + i] = __double2float_rn(sum);
}

// One stream's sum of x[0..n), for the robust chi-square that decides
// every LM step (lvt_tpu/solver/pnp.py:148; torch's sum over a batch of
// streams on the card adds in another order than over one): in the
// normal-equation kernel's fixed order, in float32, the precision lvt_tpu
// and the port's CPU path sum it in. Why float32 is enough here: the terms
// are non-negative, so nothing cancels, and each partial sum passes
// through at most ceil(n / 256) + 12 float32 additions: the result is
// within 1.7e-6 of the exact sum, relative, at n = 4096. A wider sum would
// only move which side of a rounding-level tie an LM accept test falls
// on; it would not make the card and the CPU agree there.
//
// What bounds it: 4 bytes and one add per point; launch latency sets its
// time.
__global__ void __launch_bounds__(THREADS) stream_sum_kernel(
    const float* __restrict__ x, int n, float* __restrict__ out) {
  __shared__ float part[WARPS];
  const long long s = blockIdx.x;
  x += s * n;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += THREADS) acc = __fadd_rn(acc, x[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(FULL, acc, off));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x != 0) return;
  float sum = part[0];
#pragma unroll
  for (int q = 1; q < WARPS; ++q) sum = __fadd_rn(sum, part[q]);
  out[s] = sum;
}

}  // namespace

// Input x [S, N] float32, output [S]: each stream's sum. One block per
// stream.
extern "C" int lvt_stream_sum(const float* x, int n_streams, int n,
                              float* out, void* stream) {
  if (n_streams > 0) {
    stream_sum_kernel<<<n_streams, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Inputs jac [S, M, 2, 6], w [S, M], r [S, M, 2] float32; outputs hg
// [S, 6, 7] (H and g) and h_diag [S, 6] float32. One block per stream.
extern "C" int lvt_pnp_normal_eqs(const float* jac, const float* w,
                                  const float* r, int n_streams, int m,
                                  float* hg, float* h_diag, void* stream) {
  if (n_streams > 0) {
    pnp_normal_eqs_kernel<<<n_streams, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        jac, w, r, m, hg, h_diag);
  }
  return static_cast<int>(cudaGetLastError());
}
