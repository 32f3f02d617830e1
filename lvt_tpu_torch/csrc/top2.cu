// Masked top-2 selection over a Hamming distance matrix, for Hopper.
//
// Replaces lvt_tpu/ops/top2_pallas.py::_top2_kernel (reached through
// masked_dual_top2) at its three main-path sites: map matching (two radii),
// the staged re-match (one radius) and the stereo row match (row window).
// Per query row it builds the candidate mask from the validity flags and
// either the radius tests (dx*dx + dy*dy < r2) or the row window
// (lo <= y_r <= hi), packs keys (d << 11 | col) and keeps the smallest and
// second-smallest key and the candidate count. Keys are unique per row, so
// their minimum is the top-1 with the lowest column winning ties, exactly
// as in the TPU kernel; the decode to (d1, d2, best, n_cand) is the one in
// top2_pallas.py. Radius arithmetic uses explicit round-to-nearest
// intrinsics so no FMA contraction can move a point across the radius.
//
// Design: one warp per query row; lanes stride over the K columns (one
// coalesced 128-byte read of the row per step), each lane keeps a running
// (min, second min, count) per predicate in registers, then a butterfly of
// warp shuffles merges the 32 partial results.
//
// What bounds it on the card: device-memory reads of the [M, K] int32
// matrix (6 MB at 1024 x 1536) plus the target coordinates, which stay in
// L1/L2 across rows; compute is a few integer ops per element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COL_BITS = 11;
constexpr int COL_MASK = (1 << COL_BITS) - 1;
constexpr int IMAX = 0x7fffffff;
constexpr float BIG = 1.0e9f;   // ops/hamming.py BIG
constexpr int WARPS_PER_BLOCK = 8;
constexpr unsigned FULL = 0xffffffffu;

enum Mode { RADIUS_DUAL = 0, RADIUS_SINGLE = 1, ROW = 2 };

struct Top2 {
  int k1, k2, nc;
};

__device__ __forceinline__ void push(Top2& t, int key) {
  if (key < t.k1) {
    t.k2 = t.k1;
    t.k1 = key;
  } else if (key < t.k2) {
    t.k2 = key;
  }
  t.nc += 1;
}

// merge of two (smallest, second smallest) pairs of distinct keys
__device__ __forceinline__ Top2 warp_reduce(Top2 t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int o1 = __shfl_xor_sync(FULL, t.k1, off);
    const int o2 = __shfl_xor_sync(FULL, t.k2, off);
    const int onc = __shfl_xor_sync(FULL, t.nc, off);
    t.k2 = min(max(t.k1, o1), min(t.k2, o2));
    t.k1 = min(t.k1, o1);
    t.nc += onc;
  }
  return t;
}

// out layout: fout [2 (d1, d2), 2 (predicate), m], iout [2 (best, n_cand), 2, m]
__device__ __forceinline__ void write(const Top2& t, int p, int row, int m,
                                      float* fout, long long* iout) {
  const bool has1 = t.k1 != IMAX;
  const bool has2 = t.k2 != IMAX;
  fout[(0 * 2 + p) * m + row] = has1 ? static_cast<float>(t.k1 >> COL_BITS) : BIG;
  fout[(1 * 2 + p) * m + row] = has2 ? static_cast<float>(t.k2 >> COL_BITS) : BIG;
  iout[(0 * 2 + p) * m + row] = has1 ? (t.k1 & COL_MASK) : 0;
  iout[(1 * 2 + p) * m + row] = t.nc;
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32) top2_kernel(
    const int* __restrict__ dist, const float* __restrict__ qm,
    const uint8_t* __restrict__ qv, const float* __restrict__ tm,
    const uint8_t* __restrict__ tv, int m, int k, float r2a, float r2b,
    int mode, float* __restrict__ fout, long long* __restrict__ iout) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= m) return;  // uniform across the warp
  Top2 a{IMAX, IMAX, 0};
  Top2 b{IMAX, IMAX, 0};
  if (qv[row]) {  // uniform across the warp
    const float q0 = qm[2 * row];
    const float q1 = qm[2 * row + 1];
    const int* drow = dist + static_cast<size_t>(row) * k;
    for (int c = lane; c < k; c += 32) {
      if (!tv[c]) continue;
      const int key = (drow[c] << COL_BITS) | c;
      const float tx = tm[2 * c];
      const float ty = tm[2 * c + 1];
      if (mode == ROW) {
        // (q0, q1) is the (lo, hi) row window
        if (ty >= q0 && ty <= q1) push(a, key);
      } else {
        const float dx = __fsub_rn(tx, q0);
        const float dy = __fsub_rn(ty, q1);
        const float dr2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        if (dr2 < r2a) push(a, key);
        if (mode == RADIUS_DUAL && dr2 < r2b) push(b, key);
      }
    }
  }
  a = warp_reduce(a);
  b = (mode == RADIUS_DUAL) ? warp_reduce(b) : a;
  if (lane == 0) {
    write(a, 0, row, m, fout, iout);
    write(b, 1, row, m, fout, iout);
  }
}

}  // namespace

extern "C" int lvt_masked_dual_top2(const int* dist, const float* q_meta,
                                    const uint8_t* q_valid,
                                    const float* t_meta,
                                    const uint8_t* t_valid, int m, int k,
                                    float r2a, float r2b, int mode,
                                    float* fout, long long* iout,
                                    void* stream) {
  const int blocks = (m + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  if (blocks > 0) {
    top2_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        dist, q_meta, q_valid, t_meta, t_valid, m, k, r2a, r2b, mode, fout,
        iout);
  }
  return static_cast<int>(cudaGetLastError());
}
