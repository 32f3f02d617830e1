// The tracking branch's per-point work around kernel T, five kernels over
// a leading stream axis S (lvt_tpu_torch/core/track.py and, for the map
// match, ops/matching.py; lvt_tpu runs this work as XLA ops under jit, none
// of it a TPU kernel):
//
// * predict_project_kernel: the motion model (core/motion.py), the init
//   frame's identity pose, and the map's projection and visibility at the
//   prediction (ops/matching.py::project_visible); grid (point blocks, S);
// * upkeep_pre_kernel: the map's match bookkeeping and cull with the
//   un-mark of the culled points' features (core/map.py), the frame's pose
//   and the staged points' projection; one block per stream;
// * staged_promote_kernel: the staged re-match's acceptance, one-to-one
//   resolution and claims (ops/hamming.py), the counters, and the
//   promotions inserted into the map (core/map.py::insert_points); one
//   block per stream;
// * triangulate_insert_kernel: the row match's acceptance and resolution,
//   stereo triangulation (ops/triangulate.py) or RGB-D back-projection, the
//   triangulation policy, and the insertions into the map and the staged
//   set; one block per stream;
// * map_accept_kernel: the map match's acceptance and one-to-one
//   resolution at both radii, the wide retry, the claims, the count and
//   PnP's observations and weights; one block per stream.
//
// Every float operation is written as the plain version's torch ops round
// it (__fmul_rn / __fadd_rn / __fdiv_rn: nvcc contracts nothing; `1.0 / x`
// is torch's reciprocal, an IEEE division; a Python number is its float32
// value), and the libdevice acosf / sinf / sqrtf are the functions torch's
// CUDA ops call, so each kernel gives the plain version's bits.
// resolve_one_to_one's scatter-amin is an atomicMin in shared memory
// (deterministic: a minimum); insert_points' stable argsort and cumsum are
// block-wide prefix sums of flags, in index order. Nothing is allocated
// here: every output comes from the wrapper.

#include <cuda_runtime.h>

#include <cstdint>

#include "lm_common.cuh"

namespace {

constexpr int PROJ_THREADS = 256;   // predict_project: one point a thread
constexpr int THREADS = 512;        // the one-block-per-stream kernels
constexpr int WARPS = THREADS / 32;
constexpr int IMAX = 0x7fffffff;
constexpr int DESC_WORDS = 8;

// the camera: projection and the visible bounds (core/track.py CAM_KEYS)
struct View {
  float fx, fy, cx, cy, near, far, min_x, max_x, min_y, max_y;
};

__host__ __device__ __forceinline__ View view_of(const float* p) {
  return View{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9]};
}

// se3.project_points: the guard at 1e-12 with the sign of z, then
// (fx * x) * (1 / z) + cx
__device__ __forceinline__ void project_px(float px, float py, float pz,
                                           const View& c, float& u,
                                           float& v) {
  const float eps = 1e-12f;
  const float z = fabsf(pz) < eps ? (pz < 0.0f ? -eps : eps) : pz;
  const float iz = __fdiv_rn(1.0f, z);
  u = __fadd_rn(__fmul_rn(__fmul_rn(px, c.fx), iz), c.cx);
  v = __fadd_rn(__fmul_rn(__fmul_rn(py, c.fy), iz), c.cy);
}

// se3.visibility_mask
__device__ __forceinline__ bool in_view(float z, float u, float v,
                                        const View& c) {
  return z >= c.near && z <= c.far && u >= c.min_x && u <= c.max_x &&
         v >= c.min_y && v <= c.max_y;
}

// quaternion._dot: ((a0 b0 + a1 b1) + a2 b2) + a3 b3
__device__ __forceinline__ float dot4(const float* a, const float* b) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[1], b[1])),
                __fmul_rn(a[2], b[2])),
      __fmul_rn(a[3], b[3]));
}

// quaternion.multiply (Hamilton product a * b), torch's left-to-right sums
__device__ void qmul(const float* a, const float* b, float* o) {
  const float aw = a[0], ax = a[1], ay = a[2], az = a[3];
  const float bw = b[0], bx = b[1], by = b[2], bz = b[3];
  o[0] = __fsub_rn(__fsub_rn(__fsub_rn(__fmul_rn(aw, bw), __fmul_rn(ax, bx)),
                             __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
  o[1] = __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(aw, bx), __fmul_rn(ax, bw)),
                             __fmul_rn(ay, bz)),
                   __fmul_rn(az, by));
  o[2] = __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(aw, by), __fmul_rn(ax, bz)),
                             __fmul_rn(ay, bw)),
                   __fmul_rn(az, bx));
  o[3] = __fadd_rn(__fsub_rn(__fadd_rn(__fmul_rn(aw, bz), __fmul_rn(ax, by)),
                             __fmul_rn(ay, bx)),
                   __fmul_rn(az, bw));
}

// quaternion.slerp(a, 0.5, b): torch.clamp keeps a NaN; (1 - t) theta and
// t theta are both theta * 0.5, so the two weights are one
__device__ void slerp_half(const float* a, const float* b_in, float* o) {
  const float d = dot4(a, b_in);
  float b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = d < 0.0f ? -b_in[i] : b_in[i];
  float c = fabsf(d);
  c = c < -1.0f ? -1.0f : c;
  c = c > 1.0f ? 1.0f : c;
  const float theta = acosf(c);
  const float sin_theta = sinf(theta);
  const bool near = sin_theta < 1e-6f;
  const float safe = near ? 1.0f : sin_theta;
  const float w = near ? 0.5f : __fdiv_rn(sinf(__fmul_rn(theta, 0.5f)), safe);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = __fadd_rn(__fmul_rn(w, a[i]), __fmul_rn(w, b[i]));
  normalize(o);
}

// core/motion.py::predict_next_pose and the init frame's selects: motion'
// (last_q, last_position, linear_velocity, angular_velocity) into mo[14],
// the predicted pose (t, q) into pr[7]
__device__ void predict(const float* lq, const float* lp, const float* lv,
                        const float* av, const float* t, const float* q,
                        bool init, float* mo, float* pr) {
  if (init) {
#pragma unroll
    for (int i = 0; i < 4; ++i) mo[i] = lq[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      mo[4 + i] = lp[i];
      mo[7 + i] = lv[i];
      pr[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) mo[10 + i] = av[i];
    pr[3] = 1.0f;
    pr[4] = pr[5] = pr[6] = 0.0f;
    return;
  }
  float lin[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    lin[i] = __fmul_rn(__fadd_rn(__fsub_rn(t[i], lp[i]), lv[i]), 0.5f);
  const float inv[4] = {lq[0], -lq[1], -lq[2], -lq[3]};
  float diff[4], ang[4], pq[4];
  qmul(q, inv, diff);
  slerp_half(diff, av, ang);
  normalize(ang);
  qmul(q, ang, pq);
  normalize(pq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mo[i] = q[i];
    mo[10 + i] = ang[i];
    pr[3 + i] = pq[i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    mo[4 + i] = t[i];
    mo[7 + i] = lin[i];
    pr[i] = __fadd_rn(t[i], lin[i]);
  }
}

// The exclusive count of the block's set flags before this thread's and,
// in `total`, the block's count: flags in thread order are index order.
// Every thread of the block calls it (it holds two barriers).
__device__ __forceinline__ int block_rank(bool flag, int* warp_sums,
                                          int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(FULL, flag);
  if (lane == 0) warp_sums[warp] = __popc(ballot);
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = warp_sums[w];
    before += w < warp ? c : 0;
    total += c;
  }
  __syncthreads();
  return before + __popc(ballot & ((1u << lane) - 1u));
}

// The block's sum of one int per thread
__device__ __forceinline__ int block_count(int mine, int* warp_sums) {
  int total;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mine += __shfl_xor_sync(FULL, mine, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = mine;
  __syncthreads();
  total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) total += warp_sums[w];
  __syncthreads();
  return total;
}

// hamming.accept_matches -> the match index, -1 if rejected
__device__ __forceinline__ long long accept(float d1, float d2, long long best,
                                            long long n_cand, float ratio,
                                            float abs_th) {
  const bool ok_ratio = n_cand >= 2 && d1 < __fmul_rn(d2, ratio);
  const bool ok_single = n_cand == 1 && d1 <= abs_th;
  return ok_ratio || ok_single ? best : -1;
}

// hamming.resolve_one_to_one's key of an accepted query q of n: its
// distance (an integer in f32, truncated), then its index
__device__ __forceinline__ int resolve_key(float d1, int q, int n) {
  return __float2int_rz(d1) * (n + 1) + q;
}

// One stream's queries' accepted matches reduced to each target's
// smallest key (best_key [k + 1], IMAX where none)
__device__ void resolve_keys(const float* d1, const float* d2,
                             const long long* best, const long long* n_cand,
                             int n, int k, float ratio, float abs_th,
                             int* best_key) {
  for (int j = threadIdx.x; j <= k; j += THREADS) best_key[j] = IMAX;
  __syncthreads();
  for (int q = threadIdx.x; q < n; q += THREADS) {
    const long long idx = accept(d1[q], d2[q], best[q], n_cand[q], ratio,
                                 abs_th);
    if (idx >= 0) atomicMin(&best_key[idx], resolve_key(d1[q], q, n));
  }
  __syncthreads();
}

// The resolved match of query q: its accepted match if it won its target
__device__ __forceinline__ long long resolved(const float* d1, const float* d2,
                                              const long long* best,
                                              const long long* n_cand, int q,
                                              int n, float ratio,
                                              float abs_th,
                                              const int* best_key) {
  const long long idx = accept(d1[q], d2[q], best[q], n_cand[q], ratio,
                               abs_th);
  return idx >= 0 && best_key[idx] == resolve_key(d1[q], q, n) ? idx : -1;
}

// A point store: pos [c, 3] f32, desc [c, 8] i32, counter, age [c] i32,
// valid [c] bool
struct Store {
  const float* pos;
  const int* desc;
  const int* counter;
  const int* age;
  const uint8_t* valid;
};

struct StoreOut {
  float* pos;
  int* desc;
  int* counter;
  int* age;
  uint8_t* valid;
};

__device__ __forceinline__ Store offset(Store s, long long i) {
  return Store{s.pos + 3 * i, s.desc + DESC_WORDS * i, s.counter + i,
               s.age + i, s.valid + i};
}

__device__ __forceinline__ StoreOut offset(StoreOut s, long long i) {
  return StoreOut{s.pos + 3 * i, s.desc + DESC_WORDS * i, s.counter + i,
                  s.age + i, s.valid + i};
}

// The new points of one insertion (core/map.py::insert_points): positions
// [k, 3], descriptors [k, 8], counters and ages [k] (null: zeros)
struct NewPoints {
  const float* pos;
  const int* desc;
  const int* counter;
  const int* age;
};

// insert_points of one stream: the free slots of `st` (c of them), in
// slot order, take the new points order[0, n_new) in turn; `taken` (may be
// null) marks them. Returns the points inserted. Every thread calls it.
__device__ int insert(Store st, StoreOut out, uint8_t* taken, int c,
                      const NewPoints& np, const int* order, int n_new,
                      int* warp_sums) {
  int carry = 0;
  for (int base = 0; base < c; base += THREADS) {
    const int p = base + threadIdx.x;
    const bool free_slot = p < c && !st.valid[p];
    int total;
    const int rank = carry + block_rank(free_slot, warp_sums, total);
    if (p < c) {
      const bool take = free_slot && rank < n_new;
      if (take) {
        const int src = order[rank];
#pragma unroll
        for (int i = 0; i < 3; ++i) out.pos[3 * p + i] = np.pos[3 * src + i];
#pragma unroll
        for (int w = 0; w < DESC_WORDS; ++w)
          out.desc[DESC_WORDS * p + w] = np.desc[DESC_WORDS * src + w];
        out.counter[p] = np.counter ? np.counter[src] : 0;
        out.age[p] = np.age ? np.age[src] : 0;
      } else {
#pragma unroll
        for (int i = 0; i < 3; ++i) out.pos[3 * p + i] = st.pos[3 * p + i];
#pragma unroll
        for (int w = 0; w < DESC_WORDS; ++w)
          out.desc[DESC_WORDS * p + w] = st.desc[DESC_WORDS * p + w];
        out.counter[p] = st.counter[p];
        out.age[p] = st.age[p];
      }
      out.valid[p] = st.valid[p] || take;
      if (taken) taken[p] = take;
    }
    carry += total;
  }
  return carry < n_new ? carry : n_new;
}

// ---- K1

__global__ void __launch_bounds__(PROJ_THREADS) predict_project_kernel(
    const float* __restrict__ lq, const float* __restrict__ lp,
    const float* __restrict__ lv, const float* __restrict__ av,
    const float* __restrict__ t, const float* __restrict__ q,
    const uint8_t* __restrict__ is_init, const float* __restrict__ pos,
    const uint8_t* __restrict__ valid, int m, View cam,
    float* __restrict__ motion_out, float* __restrict__ pred_out,
    float* __restrict__ uv, uint8_t* __restrict__ vis) {
  __shared__ float r[9], tw[3];
  const long long s = blockIdx.y;
  if (threadIdx.x == 0) {
    float mo[14], pr[7];
    predict(lq + 4 * s, lp + 3 * s, lv + 3 * s, av + 4 * s, t + 3 * s,
            q + 4 * s, is_init[s] != 0, mo, pr);
    world_to_camera(pr, pr + 3, r, tw);
    if (blockIdx.x == 0) {
      for (int i = 0; i < 14; ++i) motion_out[14 * s + i] = mo[i];
      for (int i = 0; i < 7; ++i) pred_out[7 * s + i] = pr[i];
    }
  }
  __syncthreads();
  const int p = blockIdx.x * PROJ_THREADS + threadIdx.x;
  if (p >= m) return;
  const long long i = s * m + p;
  float px, py, pz, u, v;
  camera_point(r, tw, pos[3 * i], pos[3 * i + 1], pos[3 * i + 2], px, py, pz);
  project_px(px, py, pz, cam, u, v);
  uv[2 * i] = u;
  uv[2 * i + 1] = v;
  vis[i] = valid[i] && in_view(pz, u, v, cam);
}

// ---- K2

__global__ void __launch_bounds__(THREADS) upkeep_pre_kernel(
    const int* __restrict__ counter, const int* __restrict__ age,
    const uint8_t* __restrict__ valid, const long long* __restrict__ match_idx,
    const uint8_t* __restrict__ fm, const uint8_t* __restrict__ fvalid,
    const float* __restrict__ pt, const float* __restrict__ pq,
    const uint8_t* __restrict__ is_init, const float* __restrict__ spos,
    const uint8_t* __restrict__ svalid, int m, int k, int n, int threshold,
    View cam, int* __restrict__ counter_out, int* __restrict__ age_out,
    uint8_t* __restrict__ valid_out, uint8_t* __restrict__ fm_out,
    uint8_t* __restrict__ targets, long long* __restrict__ map_size,
    float* __restrict__ pose_out, float* __restrict__ suv,
    uint8_t* __restrict__ svis) {
  extern __shared__ uint8_t unmark[];   // [k]
  __shared__ float r[9], tw[3];
  __shared__ int warp_sums[WARPS];
  const long long s = blockIdx.x;
  for (int f = threadIdx.x; f < k; f += THREADS) unmark[f] = 0;
  if (threadIdx.x == 0) {
    float po[7];
    const bool init = is_init[s] != 0;
    for (int i = 0; i < 3; ++i) po[i] = init ? 0.0f : pt[3 * s + i];
    for (int i = 0; i < 4; ++i)
      po[3 + i] = init ? (i == 0 ? 1.0f : 0.0f) : pq[4 * s + i];
    for (int i = 0; i < 7; ++i) pose_out[7 * s + i] = po[i];
    world_to_camera(po, po + 3, r, tw);
  }
  __syncthreads();
  // apply_match_bookkeeping, then clean_untracked with its un-marks
  int kept = 0;
  for (int p = threadIdx.x; p < m; p += THREADS) {
    const long long i = s * m + p;
    const bool v = valid[i];
    const long long idx = match_idx[i];
    const int c = counter[i] + (v && idx < 0);
    counter_out[i] = c;
    age_out[i] = age[i] + (v && idx >= 0);
    const bool remove = v && c >= threshold;
    valid_out[i] = v && !remove;
    kept += v && !remove;
    if (remove && idx >= 0) unmark[idx] = 1;
  }
  // the staged points at the frame's pose
  for (int p = threadIdx.x; p < n; p += THREADS) {
    const long long i = s * n + p;
    float px, py, pz, u, v;
    camera_point(r, tw, spos[3 * i], spos[3 * i + 1], spos[3 * i + 2], px, py,
                 pz);
    project_px(px, py, pz, cam, u, v);
    suv[2 * i] = u;
    suv[2 * i + 1] = v;
    svis[i] = svalid[i] && in_view(pz, u, v, cam);
  }
  const int size = block_count(kept, warp_sums);   // holds the barrier
  for (int f = threadIdx.x; f < k; f += THREADS) {
    const long long i = s * k + f;
    const bool claimed = fm[i] && !unmark[f];
    fm_out[i] = claimed;
    targets[i] = fvalid[i] && !claimed;
  }
  if (threadIdx.x == 0) map_size[s] = size;
}

// ---- K3

struct Top2 {
  const float* d1;
  const float* d2;
  const long long* best;
  const long long* n_cand;
};

__global__ void __launch_bounds__(THREADS) staged_promote_kernel(
    Top2 top2, Store staged, const uint8_t* __restrict__ fm,
    const long long* __restrict__ map_size, Store map, int n, int m, int k,
    float ratio, float abs_th, int staged_threshold, int soft_cap,
    int* sctr_out, uint8_t* __restrict__ svalid_out,
    uint8_t* __restrict__ fm_out, StoreOut map_out,
    uint8_t* __restrict__ taken) {
  // best_key [k + 1], then order [n] (the promotions in staged order),
  // then claims [k]
  extern __shared__ int smem[];
  int* best_key = smem;
  int* order = smem + k + 1;
  uint8_t* claims = reinterpret_cast<uint8_t*>(order + n);
  __shared__ int warp_sums[WARPS];
  const long long s = blockIdx.x;
  const Top2 t2{top2.d1 + s * n, top2.d2 + s * n, top2.best + s * n,
                top2.n_cand + s * n};
  const Store st = offset(staged, s * n);
  for (int f = threadIdx.x; f < k; f += THREADS) claims[f] = fm[s * k + f];
  resolve_keys(t2.d1, t2.d2, t2.best, t2.n_cand, n, k, ratio, abs_th,
               best_key);
  const bool small_map = map_size[s] < soft_cap;
  int carry = 0;
  for (int base = 0; base < n; base += THREADS) {
    const int q = base + threadIdx.x;
    bool promote = false;
    if (q < n) {
      const long long idx = resolved(t2.d1, t2.d2, t2.best, t2.n_cand, q, n,
                                     ratio, abs_th, best_key);
      const bool matched = idx >= 0;
      if (matched) claims[idx] = 1;
      const int c = st.counter[q];
      const bool v = st.valid[q];
      promote = v && matched && (c + 1 == staged_threshold || small_map);
      sctr_out[s * n + q] = matched ? c + 1 : c;
      svalid_out[s * n + q] = v && matched && !promote;
    }
    int total;
    const int rank = block_rank(promote, warp_sums, total);
    if (promote) order[carry + rank] = q;
    carry += total;
  }
  // (block_rank's barriers order the claims and the counters before this)
  for (int f = threadIdx.x; f < k; f += THREADS) fm_out[s * k + f] = claims[f];
  const NewPoints np{st.pos, st.desc, sctr_out + s * n, st.age};
  insert(offset(map, s * m), offset(map_out, s * m), taken + s * m, m, np,
         order, carry, warp_sums);
}

// ---- K4

// The config's scalars (core/track.py TriangulationParams)
struct TriParams {
  View cam;
  float ratio, abs_th, baseline, th2;
  int policy, staged_threshold, soft_cap;
  float window_init;
};

// triangulate._fma_chain of n terms: each float32 product exact in float64,
// added to the running sum in float64 and rounded to float32, step by step
template <int N>
__device__ __forceinline__ float fma_chain(const float* a, const float* b) {
  float acc = __double2float_rn(__dmul_rn(a[0], b[0]));
#pragma unroll
  for (int r = 1; r < N; ++r)
    acc = __double2float_rn(__dadd_rn(acc, __dmul_rn(a[r], b[r])));
  return acc;
}

// triangulate.triangulate_stereo for one pair: the camera point into p[3],
// whether it passes the gates
__device__ bool triangulate_pair(float ul, float vl, float ur, float vr,
                                 bool pair_valid, const TriParams& prm,
                                 float* p) {
  const View& c = prm.cam;
  const float x1 = __fdiv_rn(__fsub_rn(ul, c.cx), c.fx);
  const float y1 = __fdiv_rn(__fsub_rn(vl, c.cy), c.fy);
  const float x2 = __fdiv_rn(__fsub_rn(ur, c.cx), c.fx);
  const float y2 = __fdiv_rn(__fsub_rn(vr, c.cy), c.fy);
  // a3's columns over its 4 rows, and a4
  const float col[3][4] = {{-1.0f, 0.0f, -1.0f, 0.0f},
                           {0.0f, -1.0f, 0.0f, -1.0f},
                           {x1, y1, x2, y2}};
  const float a4[4] = {0.0f, 0.0f, prm.baseline, 0.0f};
  float a[3][3], b[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) a[i][j] = fma_chain<4>(col[i], col[j]);
    b[i] = -fma_chain<4>(col[i], a4);
  }
  // _solve33: the adjugate, the determinant, the chain adj @ b
  float adj[3][3];
  adj[0][0] = __fsub_rn(__fmul_rn(a[1][1], a[2][2]), __fmul_rn(a[1][2], a[2][1]));
  adj[0][1] = __fsub_rn(__fmul_rn(a[0][2], a[2][1]), __fmul_rn(a[0][1], a[2][2]));
  adj[0][2] = __fsub_rn(__fmul_rn(a[0][1], a[1][2]), __fmul_rn(a[0][2], a[1][1]));
  adj[1][0] = __fsub_rn(__fmul_rn(a[1][2], a[2][0]), __fmul_rn(a[1][0], a[2][2]));
  adj[1][1] = __fsub_rn(__fmul_rn(a[0][0], a[2][2]), __fmul_rn(a[0][2], a[2][0]));
  adj[1][2] = __fsub_rn(__fmul_rn(a[0][2], a[1][0]), __fmul_rn(a[0][0], a[1][2]));
  adj[2][0] = __fsub_rn(__fmul_rn(a[1][0], a[2][1]), __fmul_rn(a[1][1], a[2][0]));
  adj[2][1] = __fsub_rn(__fmul_rn(a[0][1], a[2][0]), __fmul_rn(a[0][0], a[2][1]));
  adj[2][2] = __fsub_rn(__fmul_rn(a[0][0], a[1][1]), __fmul_rn(a[0][1], a[1][0]));
  const float det = __fadd_rn(
      __fadd_rn(__fmul_rn(a[0][0], adj[0][0]), __fmul_rn(a[0][1], adj[0][1])),
      __fmul_rn(a[0][2], adj[0][2]));
  const float inv_det = __fdiv_rn(1.0f, fabsf(det) < 1e-20f ? 1e-20f : det);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    p[i] = __fmul_rn(fma_chain<3>(adj[i], b), inv_det);
  const bool finite = isfinite(p[0]) && isfinite(p[1]) && isfinite(p[2]);
  float u, v;
  project_px(p[0], p[1], p[2], c, u, v);
  const bool vis_l = in_view(p[2], u, v, c);
  float du = __fsub_rn(u, ul), dv = __fsub_rn(v, vl);
  const float err_l = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
  project_px(__fsub_rn(p[0], prm.baseline), p[1], p[2], c, u, v);
  const bool vis_r = in_view(p[2], u, v, c);
  du = __fsub_rn(u, ur);
  dv = __fsub_rn(v, vr);
  const float err_r = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
  return pair_valid && finite && vis_l && vis_r && err_l <= prm.th2 &&
         err_r <= prm.th2;
}

struct Features {
  const float* kp;      // [k, 2] left
  const float* rkp;     // [k, 2] right (stereo)
  const float* depth;   // [k] (RGB-D)
  const uint8_t* valid; // [k] left (RGB-D)
  const int* desc;      // [k, 8] left
};

__global__ void __launch_bounds__(THREADS) triangulate_insert_kernel(
    Top2 top2, Features feats, int k, int rgbd, const float* __restrict__ pt,
    const float* __restrict__ pq, Store map, int m, Store staged, int n,
    const float* __restrict__ last_matches,
    const long long* __restrict__ matches_count,
    const uint8_t* __restrict__ is_init, TriParams prm, StoreOut map_out,
    uint8_t* __restrict__ map_taken, StoreOut staged_out,
    long long* __restrict__ n_inserted, long long* __restrict__ map_size_out,
    float* __restrict__ window_out, float* pts,
    uint8_t* __restrict__ cand) {
  // best_key [k + 1] (stereo), then the candidates of the map and of the
  // staged set in feature order [k] each
  extern __shared__ int smem[];
  int* best_key = smem;
  int* order_map = smem + k + 1;
  int* order_staged = order_map + k;
  __shared__ int warp_sums[WARPS];
  __shared__ float rot[9];
  const long long s = blockIdx.x;
  const Store mp = offset(map, s * m);
  // the map's size after the promotions, the policy and the split
  int kept = 0;
  for (int p = threadIdx.x; p < m; p += THREADS) kept += mp.valid[p];
  const int map_size = block_count(kept, warp_sums);
  const bool init = is_init[s] != 0;
  float window[3] = {last_matches[3 * s + 1], last_matches[3 * s + 2],
                     static_cast<float>(matches_count[s])};
  bool need_tri;
  if (prm.policy == 2) {
    need_tri = true;
  } else if (prm.policy == 3) {
    need_tri = map_size < 1000;
  } else {
    need_tri = window[1] <= __fmul_rn(window[0], 0.99f) &&
               window[2] <= __fmul_rn(window[1], 0.99f);
  }
  need_tri = need_tri || init;
  const bool to_map = map_size < prm.soft_cap || prm.staged_threshold == 0;
  if (threadIdx.x == 0) {
    const float* q = pq + 4 * s;
    to_matrix(q, rot);
  }
  const float* t = pt + 3 * s;
  const long long o = s * k;
  const Top2 t2{top2.d1 + o, top2.d2 + o, top2.best + o, top2.n_cand + o};
  if (!rgbd)
    resolve_keys(t2.d1, t2.d2, t2.best, t2.n_cand, k, k, prm.ratio,
                 prm.abs_th, best_key);
  __syncthreads();
  int carry_map = 0, carry_staged = 0;
  for (int base = 0; base < k; base += THREADS) {
    const int f = base + threadIdx.x;
    bool take_map = false, take_staged = false;
    if (f < k) {
      const float ul = feats.kp[2 * (o + f)], vl = feats.kp[2 * (o + f) + 1];
      float pc[3];
      bool ok;
      if (rgbd) {
        const float d = feats.depth[o + f];
        pc[0] = __fdiv_rn(__fmul_rn(__fsub_rn(ul, prm.cam.cx), d), prm.cam.fx);
        pc[1] = __fdiv_rn(__fmul_rn(__fsub_rn(vl, prm.cam.cy), d), prm.cam.fy);
        pc[2] = d;
        ok = feats.valid[o + f];
      } else {
        const long long idx = resolved(t2.d1, t2.d2, t2.best, t2.n_cand, f, k,
                                       prm.ratio, prm.abs_th, best_key);
        const long long r = idx < 0 ? 0 : (idx > k - 1 ? k - 1 : idx);
        ok = triangulate_pair(ul, vl, feats.rkp[2 * (o + r)],
                              feats.rkp[2 * (o + r) + 1], idx >= 0, prm, pc);
      }
      // the world point: matvec(R, p) + t
      float* w = pts + 3 * (o + f);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        w[i] = __fadd_rn(mv(rot, i, pc[0], pc[1], pc[2]), t[i]);
      const bool c = ok && need_tri;
      cand[o + f] = c;
      take_map = c && to_map;
      take_staged = c && !to_map;
    }
    int total_map, total_staged;
    const int rank_map = block_rank(take_map, warp_sums, total_map);
    const int rank_staged = block_rank(take_staged, warp_sums, total_staged);
    if (take_map) order_map[carry_map + rank_map] = f;
    if (take_staged) order_staged[carry_staged + rank_staged] = f;
    carry_map += total_map;
    carry_staged += total_staged;
  }
  const NewPoints np{pts + 3 * o, feats.desc + DESC_WORDS * o, nullptr,
                     nullptr};
  const int in_map = insert(mp, offset(map_out, s * m), map_taken + s * m, m,
                            np, order_map, carry_map, warp_sums);
  const int in_staged = insert(offset(staged, s * n), offset(staged_out, s * n),
                               nullptr, n, np, order_staged, carry_staged,
                               warp_sums);
  if (threadIdx.x == 0) {
    const int size = map_size + in_map;
    n_inserted[s] = in_map + in_staged;
    map_size_out[s] = size;
    window_out[3 * s] = init ? static_cast<float>(size) : window[0];
    window_out[3 * s + 1] = init ? prm.window_init : window[1];
    window_out[3 * s + 2] = init ? prm.window_init : window[2];
  }
}

// ---- K5

// The map match after kernel T (ops/matching.py::match_projected) and the
// step's glue before PnP: each radius's acceptance and one-to-one
// resolution, the wide radius where the narrow one resolved fewer than
// retry_min, the match index (-2 invisible, -1 unmatched), the distances
// of the radius used, the claims of the valid features, the count, and
// PnP's observations (the matched feature's keypoint, feature 0's where
// unmatched) and weights. T's outputs as it writes them: fout [S, 2 (d1,
// d2), 2 (narrow, wide), M] f32, iout [S, 2 (best, n_cand), 2, M] int64.
// One block per stream.
__global__ void __launch_bounds__(THREADS) map_accept_kernel(
    const float* __restrict__ fout, const long long* __restrict__ iout,
    const uint8_t* __restrict__ visible, const uint8_t* __restrict__ fvalid,
    const float* __restrict__ kp, int m, int k, float ratio, float abs_th,
    int retry_min, long long* __restrict__ match_idx,
    float* __restrict__ d1_out, float* __restrict__ d2_out,
    uint8_t* __restrict__ fm_out, long long* __restrict__ count_out,
    uint8_t* __restrict__ wide_out, float* __restrict__ obs,
    float* __restrict__ weights) {
  // best_key of each radius [k + 1], then the claims [k]
  extern __shared__ int smem[];
  int* key_a = smem;
  int* key_b = smem + k + 1;
  uint8_t* claims = reinterpret_cast<uint8_t*>(key_b + k + 1);
  __shared__ int warp_sums[WARPS];
  const long long s = blockIdx.x;
  const float* f = fout + 4 * s * m;
  const long long* g = iout + 4 * s * m;
  const Top2 a{f, f + 2 * m, g, g + 2 * m};
  const Top2 b{f + m, f + 3 * m, g + m, g + 3 * m};
  for (int j = threadIdx.x; j < k; j += THREADS) claims[j] = 0;
  resolve_keys(a.d1, a.d2, a.best, a.n_cand, m, k, ratio, abs_th, key_a);
  resolve_keys(b.d1, b.d2, b.best, b.n_cand, m, k, ratio, abs_th, key_b);
  int mine = 0;
  for (int q = threadIdx.x; q < m; q += THREADS)
    mine += resolved(a.d1, a.d2, a.best, a.n_cand, q, m, ratio, abs_th,
                     key_a) >= 0;
  const bool wide = block_count(mine, warp_sums) < retry_min;
  // the radius used, pointer by pointer (a selected struct would live in
  // local memory)
  const float* ud1 = wide ? b.d1 : a.d1;
  const float* ud2 = wide ? b.d2 : a.d2;
  const long long* ubest = wide ? b.best : a.best;
  const long long* un = wide ? b.n_cand : a.n_cand;
  const int* key_u = wide ? key_b : key_a;
  mine = 0;
  for (int q = threadIdx.x; q < m; q += THREADS) {
    const long long idx = resolved(ud1, ud2, ubest, un, q, m, ratio, abs_th,
                                   key_u);
    const long long at = s * m + q;
    const long long mi = visible[at] ? (idx >= 0 ? idx : -1) : -2;
    const long long src = mi < 0 ? 0 : (mi > k - 1 ? k - 1 : mi);
    match_idx[at] = mi;
    d1_out[at] = ud1[q];
    d2_out[at] = ud2[q];
    obs[2 * at] = kp[2 * (s * k + src)];
    obs[2 * at + 1] = kp[2 * (s * k + src) + 1];
    weights[at] = mi >= 0 ? 1.0f : 0.0f;
    if (idx >= 0) {
      claims[idx] = 1;
      ++mine;
    }
  }
  // (block_count's barriers order the claims before they are read)
  const int count = block_count(mine, warp_sums);
  for (int j = threadIdx.x; j < k; j += THREADS)
    fm_out[s * k + j] = claims[j] && fvalid[s * k + j];
  if (threadIdx.x == 0) {
    count_out[s] = count;
    wide_out[s] = wide;
  }
}

// Raises the kernel's dynamic shared memory limit to `bytes` when it
// exceeds the default 48 KB (a host-side call, allowed during capture).
template <typename K>
cudaError_t smem_limit(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// K1: motion state (lq [S, 4], lp [S, 3], lv [S, 3], av [S, 4]), the last
// pose (t [S, 3], q [S, 4]), is_init [S], the map's pos [S, M, 3] and valid
// [S, M]; cam [10] on the host -> motion' [S, 14], predicted [S, 7], uv
// [S, M, 2], visible [S, M]. Grid (point blocks, S).
extern "C" int lvt_predict_project(
    const float* lq, const float* lp, const float* lv, const float* av,
    const float* t, const float* q, const void* is_init, const float* pos,
    const void* valid, int n_streams, int m, const float* cam,
    float* motion_out, float* pred_out, float* uv, void* vis, void* stream) {
  if (n_streams > 0) {
    const dim3 grid(m > 0 ? (m + PROJ_THREADS - 1) / PROJ_THREADS : 1,
                    n_streams);
    predict_project_kernel<<<grid, PROJ_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        lq, lp, lv, av, t, q, static_cast<const uint8_t*>(is_init), pos,
        static_cast<const uint8_t*>(valid), m, view_of(cam), motion_out,
        pred_out, uv, static_cast<uint8_t*>(vis));
  }
  return static_cast<int>(cudaGetLastError());
}

// K2: the map's counter, age [S, M] int32, valid [S, M], match_idx [S, M]
// int64, claims and the features' validity [S, K], PnP's pose (t, q),
// is_init [S], the staged pos [S, N, 3] and valid [S, N] -> counter', age',
// valid' [S, M], claims', the staged targets [S, K], map size [S] int64,
// pose [S, 7], staged uv [S, N, 2] and visible [S, N]. One block a stream.
extern "C" int lvt_upkeep_pre(
    const int* counter, const int* age, const void* valid,
    const long long* match_idx, const void* fm, const void* fvalid,
    const float* t, const float* q, const void* is_init, const float* spos,
    const void* svalid, int n_streams, int m, int k, int n, int threshold,
    const float* cam, int* counter_out, int* age_out, void* valid_out,
    void* fm_out, void* targets, long long* map_size, float* pose_out,
    float* suv, void* svis, void* stream) {
  if (n_streams > 0) {
    upkeep_pre_kernel<<<n_streams, THREADS, k,
                        static_cast<cudaStream_t>(stream)>>>(
        counter, age, static_cast<const uint8_t*>(valid), match_idx,
        static_cast<const uint8_t*>(fm), static_cast<const uint8_t*>(fvalid),
        t, q, static_cast<const uint8_t*>(is_init), spos,
        static_cast<const uint8_t*>(svalid), m, k, n, threshold, view_of(cam),
        counter_out, age_out, static_cast<uint8_t*>(valid_out),
        static_cast<uint8_t*>(fm_out), static_cast<uint8_t*>(targets),
        map_size, pose_out, suv, static_cast<uint8_t*>(svis));
  }
  return static_cast<int>(cudaGetLastError());
}

// K3: the staged site's top-2 (d1, d2 [S, N] f32, best, n_cand [S, N]
// int64), the staged set (pos, desc, counter, age, valid [S, N]), the claims
// [S, K], the map size [S] int64, the map (pos, desc, counter, age, valid
// [S, M]) -> staged counter', valid' [S, N], claims' [S, K], the map' (5
// leaves) and its slots taken [S, M]. One block a stream.
extern "C" int lvt_staged_promote(
    const float* d1, const float* d2, const long long* best,
    const long long* n_cand, const float* spos, const int* sdesc,
    const int* sctr, const int* sage, const void* svalid, const void* fm,
    const long long* map_size, const float* mpos, const int* mdesc,
    const int* mctr, const int* mage, const void* mvalid, int n_streams,
    int n, int m, int k, float ratio, float abs_th, int staged_threshold,
    int soft_cap, int* sctr_out, void* svalid_out, void* fm_out,
    float* mpos_out, int* mdesc_out, int* mctr_out, int* mage_out,
    void* mvalid_out, void* taken, void* stream) {
  const size_t smem = sizeof(int) * (k + 1 + n) + k;
  const cudaError_t err = smem_limit(staged_promote_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_streams > 0) {
    staged_promote_kernel<<<n_streams, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        Top2{d1, d2, best, n_cand},
        Store{spos, sdesc, sctr, sage, static_cast<const uint8_t*>(svalid)},
        static_cast<const uint8_t*>(fm), map_size,
        Store{mpos, mdesc, mctr, mage, static_cast<const uint8_t*>(mvalid)},
        n, m, k, ratio, abs_th, staged_threshold, soft_cap, sctr_out,
        static_cast<uint8_t*>(svalid_out), static_cast<uint8_t*>(fm_out),
        StoreOut{mpos_out, mdesc_out, mctr_out, mage_out,
                 static_cast<uint8_t*>(mvalid_out)},
        static_cast<uint8_t*>(taken));
  }
  return static_cast<int>(cudaGetLastError());
}

// K4: the row site's top-2 ([S, K]; unread with rgbd), the left keypoints
// [S, K, 2], the right ones [S, K, 2] (stereo), the depth [S, K] (rgbd),
// the left validity [S, K] (rgbd) and descriptors [S, K, 8], the pose (t,
// q), the map and the staged set, last_matches [S, 3], the match count [S]
// int64, is_init [S]; fl [14] on the host: the camera (10), the row ratio
// and absolute thresholds, the baseline, reprojection_th2 -> the map' (5
// leaves), its slots taken [S, M], the staged set' (5 leaves), the points
// inserted [S] int64, the map size [S] int64, the window [S, 3], the world
// points [S, K, 3], the candidates [S, K]. One block a stream.
extern "C" int lvt_triangulate_insert(
    const float* d1, const float* d2, const long long* best,
    const long long* n_cand, const float* kp, const float* rkp,
    const float* depth, const void* fvalid, const int* desc, const float* t,
    const float* q, const float* mpos, const int* mdesc, const int* mctr,
    const int* mage, const void* mvalid, const float* spos, const int* sdesc,
    const int* sctr, const int* sage, const void* svalid,
    const float* last_matches, const long long* matches_count,
    const void* is_init, int n_streams, int k, int m, int n, int rgbd,
    const float* fl, int policy, int staged_threshold, int soft_cap,
    float window_init, float* mpos_out, int* mdesc_out, int* mctr_out,
    int* mage_out, void* mvalid_out, void* map_taken, float* spos_out,
    int* sdesc_out, int* sctr_out, int* sage_out, void* svalid_out,
    long long* n_inserted, long long* map_size, float* window, float* pts,
    void* cand, void* stream) {
  const size_t smem = sizeof(int) * (3 * k + 1);
  const cudaError_t err = smem_limit(triangulate_insert_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_streams > 0) {
    const TriParams prm{view_of(fl), fl[10], fl[11], fl[12], fl[13], policy,
                        staged_threshold, soft_cap, window_init};
    triangulate_insert_kernel<<<n_streams, THREADS, smem,
                                static_cast<cudaStream_t>(stream)>>>(
        Top2{d1, d2, best, n_cand},
        Features{kp, rkp, depth, static_cast<const uint8_t*>(fvalid), desc},
        k, rgbd, t, q,
        Store{mpos, mdesc, mctr, mage, static_cast<const uint8_t*>(mvalid)},
        m, Store{spos, sdesc, sctr, sage, static_cast<const uint8_t*>(svalid)},
        n, last_matches, matches_count, static_cast<const uint8_t*>(is_init),
        prm,
        StoreOut{mpos_out, mdesc_out, mctr_out, mage_out,
                 static_cast<uint8_t*>(mvalid_out)},
        static_cast<uint8_t*>(map_taken),
        StoreOut{spos_out, sdesc_out, sctr_out, sage_out,
                 static_cast<uint8_t*>(svalid_out)},
        n_inserted, map_size, window, pts, static_cast<uint8_t*>(cand));
  }
  return static_cast<int>(cudaGetLastError());
}

// K5: T's outputs at the map site (fout [S, 2, 2, M] f32, iout [S, 2, 2, M]
// int64), visible [S, M], the features' validity [S, K] and keypoints [S,
// K, 2] -> match_idx [S, M] int64, d1, d2 [S, M] f32, claims [S, K], the
// count [S] int64, the wide radius used [S], obs [S, M, 2] and weights
// [S, M] f32. One block a stream.
extern "C" int lvt_map_accept(
    const float* fout, const long long* iout, const void* visible,
    const void* fvalid, const float* kp, int n_streams, int m, int k,
    float ratio, float abs_th, int retry_min, long long* match_idx,
    float* d1, float* d2, void* fm, long long* count, void* wide, float* obs,
    float* weights, void* stream) {
  if (n_streams > 0) {
    const size_t smem = sizeof(int) * 2 * (k + 1) + k;
    map_accept_kernel<<<n_streams, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        fout, iout, static_cast<const uint8_t*>(visible),
        static_cast<const uint8_t*>(fvalid), kp, m, k, ratio, abs_th,
        retry_min, match_idx, d1, d2, static_cast<uint8_t*>(fm), count,
        static_cast<uint8_t*>(wide), obs, weights);
  }
  return static_cast<int>(cudaGetLastError());
}
