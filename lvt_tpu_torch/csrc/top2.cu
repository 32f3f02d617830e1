// Kernel T for Hopper: masked dual top-2 straight from BRIEF descriptors.
//
// Replaces lvt_tpu/ops/top2_pallas.py::_top2_kernel (reached through
// masked_dual_top2) at its four sites: map matching (two radii), the staged
// re-match (one radius), the stereo row match and the BA row match (row
// window). In lvt_tpu the [M, K] Hamming matrix it reads is XLA's work
// (XOR + popcount, outside the Pallas kernel); here the distance is
// computed in the kernel and the matrix never exists. lvt_tpu builds one
// row Hamming matrix for both row matches (their query sets are
// complementary); its counterpart here is the dual row mode, one launch
// that computes the top-2 of both query sets over the same window.
//
// One launch serves S independent streams (the multi-stream step, where
// lvt_tpu vmaps the matching): blockIdx.y is the stream, and each stream
// reads its own [M] queries and [K] targets and writes its own outputs, at
// a stride of one stream's slice. The radii and the mode are shared. With
// S = 1 it is the single-stream launch.
//
// Per query row it builds the candidate mask from the validity flags and
// either the radius tests (dx*dx + dy*dy < r2) or the row window
// (lo <= y_r <= hi). In the row modes the query metadata is the left
// keypoint, and the window is computed here as lvt_tpu's row_match does
// (lvt_tpu/ops/matching.py:189-191): lo = max(floor(y) - r, 0) and
// hi = min(floor(y) + r, rows) in float32 (a NaN stays NaN, as torch's
// clamp keeps it, and matches nothing); the query set is valid & ~excl
// (ROW), and in ROW_DUAL the second predicate's valid & incl. For a candidate the distance is the sum of
// __popc(q[w] ^ t[w]) over the 8 descriptor words; keys (d << 11 | col)
// are unique per row, so their minimum is the top-1 with the lowest column
// winning ties, exactly as in the TPU kernel, and the decode to
// (d1, d2, best, n_cand) is the one in top2_pallas.py. Radius arithmetic
// uses explicit round-to-nearest intrinsics so no FMA contraction can move
// a point across the radius.
//
// What bounds it: with the matrix gone it reads ~0.1 MB of descriptors,
// coordinates and flags, and computes 8 XOR + popcount pairs per candidate
// pair (popcount: 16 per SM per clock) plus a few float operations per
// valid pair; at the main path's shapes (1024 or 1536 x 1536, a few
// percent of pairs are candidates) both are microseconds, so launch
// latency and the dependent loop set its time. What the design does about
// the old kernel's limits (under one block per SM, one 48-step latency-
// bound loop per lane, and a 6-9 MB matrix built by ~15 elementwise passes
// over a [M, K, 8] tensor): a block owns ROWS query rows, keeps their
// descriptor words in registers and lets its warps split the K columns, so
// M = 1024 runs 256 blocks of 8 warps (some 16 warps per SM) and each lane
// takes ~6 columns; a lane loads a target's 8 words as two 16-byte loads
// plus its coordinates and validity once, and tests it against all ROWS
// rows. Running (k1, k2, n) per row and predicate are merged by a shuffle
// butterfly within each warp, then across the warps through shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COL_BITS = 11;
constexpr int COL_MASK = (1 << COL_BITS) - 1;
constexpr int IMAX = 0x7fffffff;
constexpr float BIG = 1.0e9f;   // ops/hamming.py BIG
constexpr int ROWS = 4;         // query rows per block
constexpr int WARPS = 8;        // warps per block, splitting the columns
constexpr unsigned FULL = 0xffffffffu;

enum Mode { RADIUS_DUAL = 0, RADIUS_SINGLE = 1, ROW = 2, ROW_DUAL = 3 };

// two predicates, each reduced apart
__host__ __device__ constexpr bool dual(int mode) {
  return mode == RADIUS_DUAL || mode == ROW_DUAL;
}

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
__device__ __forceinline__ void merge(Top2& t, int o1, int o2, int onc) {
  t.k2 = min(max(t.k1, o1), min(t.k2, o2));
  t.k1 = min(t.k1, o1);
  t.nc += onc;
}

__device__ __forceinline__ void warp_reduce(Top2& t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int o1 = __shfl_xor_sync(FULL, t.k1, off);
    const int o2 = __shfl_xor_sync(FULL, t.k2, off);
    const int onc = __shfl_xor_sync(FULL, t.nc, off);
    merge(t, o1, o2, onc);
  }
}

__device__ __forceinline__ int hamming(const uint32_t* q, int4 lo, int4 hi) {
  return __popc(q[0] ^ lo.x) + __popc(q[1] ^ lo.y) + __popc(q[2] ^ lo.z) +
         __popc(q[3] ^ lo.w) + __popc(q[4] ^ hi.x) + __popc(q[5] ^ hi.y) +
         __popc(q[6] ^ hi.z) + __popc(q[7] ^ hi.w);
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

template <int MODE>
__global__ void __launch_bounds__(WARPS * 32) hamming_top2_kernel(
    const int4* __restrict__ q_desc, const int4* __restrict__ t_desc,
    const float* __restrict__ qm, const uint8_t* __restrict__ qv,
    const float* __restrict__ tm, const uint8_t* __restrict__ tv,
    const uint8_t* __restrict__ qx, const uint8_t* __restrict__ qi, int m,
    int k, float r2a, float r2b, float row_r, float rows,
    float* __restrict__ fout, long long* __restrict__ iout) {
  __shared__ int part[WARPS][ROWS][2][3];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * ROWS;
  // this block's stream: its slices of every input and output
  const long long s = blockIdx.y;
  q_desc += s * m * 2;
  t_desc += s * k * 2;
  qm += s * m * 2;
  qv += s * m;
  if (MODE == ROW || MODE == ROW_DUAL) qx += s * m;
  if (MODE == ROW_DUAL) qi += s * m;
  tm += s * k * 2;
  tv += s * k;
  fout += s * 4 * m;
  iout += s * 4 * m;

  uint32_t q[ROWS][8];
  // radius modes: the query's (x, y); row modes: its window (lo, hi)
  float q0[ROWS], q1[ROWS];
  bool oka[ROWS], okb[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = row0 + r;
    const bool v = row < m && qv[row];
    if (MODE == ROW || MODE == ROW_DUAL) {
      oka[r] = v && !qx[row];
      okb[r] = MODE == ROW_DUAL && v && qi[row];
    } else {
      oka[r] = v;
      okb[r] = v;
    }
    const bool ok = oka[r] || okb[r];
    const int4 lo = ok ? q_desc[2 * row] : make_int4(0, 0, 0, 0);
    const int4 hi = ok ? q_desc[2 * row + 1] : make_int4(0, 0, 0, 0);
    q[r][0] = lo.x; q[r][1] = lo.y; q[r][2] = lo.z; q[r][3] = lo.w;
    q[r][4] = hi.x; q[r][5] = hi.y; q[r][6] = hi.z; q[r][7] = hi.w;
    q0[r] = ok ? qm[2 * row] : 0.0f;
    q1[r] = ok ? qm[2 * row + 1] : 0.0f;
    if (MODE == ROW || MODE == ROW_DUAL) {
      // matching.row_match's window: the clamps keep a NaN
      const float y = floorf(q1[r]);
      const float lo_y = __fsub_rn(y, row_r), hi_y = __fadd_rn(y, row_r);
      q0[r] = lo_y < 0.0f ? 0.0f : lo_y;
      q1[r] = hi_y > rows ? rows : hi_y;
    }
  }

  Top2 a[ROWS], b[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    a[r] = Top2{IMAX, IMAX, 0};
    b[r] = Top2{IMAX, IMAX, 0};
  }

  for (int c = warp * 32 + lane; c < k; c += WARPS * 32) {
    if (!tv[c]) continue;
    const float tx = tm[2 * c];
    const float ty = tm[2 * c + 1];
    bool any = false;
    bool pa[ROWS], pb[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (MODE == ROW || MODE == ROW_DUAL) {
        // (q0, q1) is the (lo, hi) row window
        const bool in = ty >= q0[r] && ty <= q1[r];
        pa[r] = oka[r] && in;
        pb[r] = okb[r] && in;
      } else {
        const float dx = __fsub_rn(tx, q0[r]);
        const float dy = __fsub_rn(ty, q1[r]);
        const float dr2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        pa[r] = oka[r] && dr2 < r2a;
        pb[r] = MODE == RADIUS_DUAL && oka[r] && dr2 < r2b;
      }
      any = any || pa[r] || pb[r];
    }
    if (!any) continue;
    const int4 lo = t_desc[2 * c];
    const int4 hi = t_desc[2 * c + 1];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (!(pa[r] || pb[r])) continue;
      const int key = (hamming(q[r], lo, hi) << COL_BITS) | c;
      if (pa[r]) push(a[r], key);
      if (pb[r]) push(b[r], key);
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    warp_reduce(a[r]);
    if (dual(MODE)) warp_reduce(b[r]);
    if (lane == 0) {
      part[warp][r][0][0] = a[r].k1;
      part[warp][r][0][1] = a[r].k2;
      part[warp][r][0][2] = a[r].nc;
      part[warp][r][1][0] = b[r].k1;
      part[warp][r][1][1] = b[r].k2;
      part[warp][r][1][2] = b[r].nc;
    }
  }
  __syncthreads();

  // one thread per (row, predicate) merges the warps' partial results
  const int t = threadIdx.x;
  if (t >= ROWS * 2) return;
  const int r = t >> 1;
  const int row = row0 + r;
  if (row >= m) return;
  const int p = dual(MODE) ? (t & 1) : 0;  // one predicate, twice
  Top2 acc{IMAX, IMAX, 0};
#pragma unroll
  for (int w = 0; w < WARPS; ++w)
    merge(acc, part[w][r][p][0], part[w][r][p][1], part[w][r][p][2]);
  write(acc, t & 1, row, m, fout, iout);
}

}  // namespace

// Inputs [S, M, 8], [S, K, 8], [S, M, 2], [S, M], [S, K, 2], [S, K], and
// in the row modes the exclusion [S, M] (and in ROW_DUAL the second set
// [S, M]); outputs fout, iout [S, 2, 2, M]. The grid is (row blocks, S).
extern "C" int lvt_hamming_top2(const int* q_desc, const int* t_desc,
                                const float* q_meta, const uint8_t* q_valid,
                                const float* t_meta, const uint8_t* t_valid,
                                const uint8_t* q_excl, const uint8_t* q_incl,
                                int n_streams, int m, int k, float r2a,
                                float r2b, float row_r, float rows, int mode,
                                float* fout, long long* iout, void* stream) {
  if (n_streams > 65535 || mode < RADIUS_DUAL || mode > ROW_DUAL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 blocks((m + ROWS - 1) / ROWS, n_streams);
  if (blocks.x > 0 && blocks.y > 0) {
    const auto* qd = reinterpret_cast<const int4*>(q_desc);
    const auto* td = reinterpret_cast<const int4*>(t_desc);
    const auto s = static_cast<cudaStream_t>(stream);
#define LVT_T_LAUNCH(MODE)                                                   \
  hamming_top2_kernel<MODE><<<blocks, WARPS * 32, 0, s>>>(                   \
      qd, td, q_meta, q_valid, t_meta, t_valid, q_excl, q_incl, m, k, r2a, \
      r2b, row_r, rows, fout, iout)
    switch (mode) {
      case RADIUS_DUAL: LVT_T_LAUNCH(RADIUS_DUAL); break;
      case RADIUS_SINGLE: LVT_T_LAUNCH(RADIUS_SINGLE); break;
      case ROW: LVT_T_LAUNCH(ROW); break;
      default: LVT_T_LAUNCH(ROW_DUAL); break;
    }
#undef LVT_T_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}
