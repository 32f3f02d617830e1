// The tracking branch's per-point work around kernel T, five kernels over
// a leading stream axis S (lvt_tpu_torch/core/track.py and, for the map
// match, ops/matching.py; lvt_tpu runs this work as XLA ops under jit, none
// of it a TPU kernel):
//
// * predict_project_kernel: the motion model (core/motion.py), the init
//   frame's identity pose, and the map's projection and visibility at the
//   prediction (ops/matching.py::project_visible); grid (point blocks of
//   PROJ_THREADS, S), no shared memory and no barrier;
// * upkeep_pre_kernel: the map's match bookkeeping and cull with the
//   un-mark of the culled points' features (core/map.py), the frame's pose
//   and the staged points' projection; one block per stream, two barriers;
// * staged_promote_kernel: the staged re-match's acceptance, one-to-one
//   resolution and claims (ops/hamming.py), the counters, and the
//   promotions inserted into the map (core/map.py::insert_points); a
//   thread-block cluster per stream, the staged points, the features
//   (the resolution's targets) and the map's slots spread over its blocks;
// * triangulate_insert_kernel: the row match's acceptance and resolution,
//   stereo triangulation (ops/triangulate.py) or RGB-D back-projection, the
//   triangulation policy, and the insertions into the map and the staged
//   set; a thread-block cluster per stream, the features (queries and
//   targets), the map's and the staged set's slots spread over its blocks;
// * map_accept_kernel: the map match's acceptance and one-to-one
//   resolution at both radii, the wide retry, the claims, the count and
//   PnP's observations and weights; one block per stream, two barriers;
// * ba_observe_kernel: with local BA on, the BA row match's acceptance and
//   one-to-one resolution (kernel T's second row set), each map slot's
//   right-camera observation, and the observation window's slide with its
//   schedule (core/step.py's local BA); a block per stream for the
//   resolution and the newest row, two barriers, and copy blocks beside it
//   for the older rows.
//
// Every float operation is written as the plain version's torch ops round
// it (__fmul_rn / __fadd_rn / __fdiv_rn: nvcc contracts nothing; `1.0 / x`
// is torch's reciprocal, an IEEE division; a Python number is its float32
// value), and the libdevice acosf / sinf / sqrtf are the functions torch's
// CUDA ops call, so each kernel gives the plain version's bits.
// resolve_one_to_one's scatter-amin is an atomicMin in shared memory
// (deterministic: a minimum), in the cluster kernels into the shared memory
// of the block that owns the target; insert_points' stable argsort and
// cumsum are prefix sums of flags in index order, block-wide and, in the
// cluster kernels, over the blocks' counts in rank order. Nothing is
// allocated here: every output comes from the wrapper.
//
// What bounds these kernels: their bytes and operations take the card well
// under a microsecond (chip_smoke.py's bound); their time is the chain of a
// stream's steps, each a memory latency or a barrier. A block barrier waits
// for every load issued before it. The two one-block kernels give each
// thread one query or map point, one staged point and at most two features
// (K <= 2048), issue all of their loads before the first barrier (one
// round trip of ~50 KB on one SM), keep them in registers or shared memory
// to the end, and need two barriers each. A cluster
// of C blocks per stream issues every independent load at the start,
// spreads the float64 triangulation over C SMs and exchanges only integer
// counts and keys over distributed shared memory: four cluster barriers,
// each arrive with release semantics ~1k cycles on the card but the last
// (scripts/torch_track_clocks.py stamps each phase's clocks per block at
// the TRACK_CLOCK markers).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "lm_common.cuh"

namespace cg = cooperative_groups;

namespace {

// predict_project: one point a thread; 128 spreads path 1's M = 1024 over
// 8 blocks (SMs) a stream and path 5's 4096 over 32
constexpr int PROJ_THREADS = 128;
// the one-block-per-stream kernels (upkeep_pre, map_accept): a query, a map
// point and a staged point a thread, and two features (K <= 2 THREADS)
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
static_assert(WARPS == 32, "block_sum2 reads a warp's sum a lane");
// the cluster kernels (staged_promote, triangulate_insert): a block's
// threads (one feature each at C = 8 up to K = 2048), and the most blocks
// a stream's cluster takes (the portable cluster size)
constexpr int CLUSTER_THREADS = 256;
constexpr int CLUSTER_WARPS = CLUSTER_THREADS / 32;
constexpr int CLUSTER_MAX = 8;
constexpr int SMEM_MAX = 232448;    // shared memory a block may take
constexpr int IMAX = 0x7fffffff;
constexpr int DESC_WORDS = 8;

// Phase markers: nothing here; scripts/torch_track_clocks.py defines them
// to stamp the SM clock in each block
#ifndef TRACK_CLOCK
#define TRACK_CLOCK(slot)
#endif

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
// Every thread of a cluster kernel's block calls it (two barriers).
__device__ __forceinline__ int block_rank(bool flag, int* warp_sums,
                                          int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(FULL, flag);
  if (lane == 0) warp_sums[warp] = __popc(ballot);
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < CLUSTER_WARPS; ++w) {
    const int c = warp_sums[w];
    before += w < warp ? c : 0;
    total += c;
  }
  __syncthreads();
  return before + __popc(ballot & ((1u << lane) - 1u));
}

// The block's sums of two ints a thread, in every thread of a block of
// THREADS: one barrier (each warp's slot is written once, and read after it
// by one lane of every warp)
__device__ __forceinline__ int2 block_sum2(int a, int b, int2* warp_sums) {
  a = __reduce_add_sync(FULL, a);
  b = __reduce_add_sync(FULL, b);
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[threadIdx.x >> 5] = make_int2(a, b);
  __syncthreads();
  const int2 w = warp_sums[lane];
  return make_int2(__reduce_add_sync(FULL, w.x), __reduce_add_sync(FULL, w.y));
}

// A load issued where it stands: a coherent load (ptxas keeps it ahead of
// the next barrier, which waits for it; a read-only one it may sink past
// the barrier to its use) whose value is an opaque register (so it is
// neither moved nor issued again where the value is used)
__device__ __forceinline__ int load_now(const int* p) {
  int x = __ldca(p);
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ int load_now(const uint8_t* p) {
  int x = __ldca(p);
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ float load_now(const float* p) {
  float x = __ldca(p);
  asm volatile("" : "+f"(x));
  return x;
}

__device__ __forceinline__ long long load_now(const long long* p) {
  long long x = __ldca(p);
  asm volatile("" : "+l"(x));
  return x;
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

// ---- K1

// Every thread issues its point's loads, then the stream's motion state,
// pose and init flag (the same addresses in every thread of the block), and
// builds the prediction and the rotation itself (the same functions: the
// same bits); block 0's thread 0 writes motion' and the prediction. So the
// chain is one round trip of loads, the pose algebra, the projection and
// the stores: no thread-0 prologue, no barrier.
__global__ void __launch_bounds__(PROJ_THREADS) predict_project_kernel(
    const float* __restrict__ lq, const float* __restrict__ lp,
    const float* __restrict__ lv, const float* __restrict__ av,
    const float* __restrict__ t, const float* __restrict__ q,
    const uint8_t* __restrict__ is_init, const float* __restrict__ pos,
    const uint8_t* __restrict__ valid, int m, View cam,
    float* __restrict__ motion_out, float* __restrict__ pred_out,
    float* __restrict__ uv, uint8_t* __restrict__ vis) {
  const long long s = blockIdx.y;
  const int p = blockIdx.x * PROJ_THREADS + threadIdx.x;
  const bool own = p < m;
  const long long i = s * m + p;
  TRACK_CLOCK(80);
  float x = 0.0f, y = 0.0f, z = 0.0f;
  int v = 0;
  if (own) {
    x = load_now(pos + 3 * i);
    y = load_now(pos + 3 * i + 1);
    z = load_now(pos + 3 * i + 2);
    v = load_now(valid + i);
  }
  // lq 4, lp 3, lv 3, av 4, t 3, q 4
  float in[21];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    in[j] = load_now(lq + 4 * s + j);
    in[10 + j] = load_now(av + 4 * s + j);
    in[17 + j] = load_now(q + 4 * s + j);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    in[4 + j] = load_now(lp + 3 * s + j);
    in[7 + j] = load_now(lv + 3 * s + j);
    in[14 + j] = load_now(t + 3 * s + j);
  }
  const bool init = load_now(is_init + s) != 0;
  float mo[14], pr[7], r[9], tw[3];
  predict(in, in + 4, in + 7, in + 10, in + 14, in + 17, init, mo, pr);
  world_to_camera(pr, pr + 3, r, tw);
  TRACK_CLOCK(81);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int j = 0; j < 14; ++j) motion_out[14 * s + j] = mo[j];
    for (int j = 0; j < 7; ++j) pred_out[7 * s + j] = pr[j];
  }
  if (own) {
    float px, py, pz, u, w;
    camera_point(r, tw, x, y, z, px, py, pz);
    project_px(px, py, pz, cam, u, w);
    uv[2 * i] = u;
    uv[2 * i + 1] = w;
    vis[i] = v != 0 && in_view(pz, u, w, cam);
  }
  TRACK_CLOCK(89);
}

// ---- K2

// A staged point's pixel and visibility at the frame's pose (r, tw)
struct Seen {
  float u, v;
  bool vis;
};

__device__ __forceinline__ Seen project_staged(const float* r, const float* tw,
                                               float x, float y, float z,
                                               bool valid, const View& cam) {
  float px, py, pz;
  Seen o;
  camera_point(r, tw, x, y, z, px, py, pz);
  project_px(px, py, pz, cam, o.u, o.v);
  o.vis = valid && in_view(pz, o.u, o.v, cam);
  return o;
}

// apply_match_bookkeeping and clean_untracked for one map point: its
// counter' and age', whether it stays, and the feature it un-marks (-1:
// none; the claim mask drops K)
struct Kept {
  int counter, age;
  bool stays;
  int unmark;
};

__device__ __forceinline__ Kept bookkeep(int ctr, int ag, bool v,
                                        long long idx, int threshold, int k) {
  const int c = ctr + (v && idx < 0);
  const bool remove = v && c >= threshold;
  return Kept{c, ag + (v && idx >= 0), v && !remove,
              remove && idx >= 0 && idx < k ? static_cast<int>(idx) : -1};
}

// Every input of the thread's map point, staged point and two features,
// and the pose, is loaded before the first barrier, which orders the
// un-marks' clearing before they are set; the second (with the warp sums
// of the kept count) orders them before they are read. Every warp builds
// the pose's rotation itself (the same function: the same bits). The
// thread's own outputs go out after the last barrier. Further tiles of
// THREADS (M or N > THREADS) load and write as they go, two at a time.
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
  extern __shared__ uint32_t unmark_words[];   // the un-marks, a byte [k]
  uint8_t* const unmark = reinterpret_cast<uint8_t*>(unmark_words);
  __shared__ int2 warp_sums[WARPS];
  const long long s = blockIdx.x;
  const int tid = threadIdx.x;
  TRACK_CLOCK(50);
  for (int w = tid; 4 * w < k; w += THREADS) unmark_words[w] = 0;
  const long long ip = s * m + tid, is = s * n + tid;
  int ctr = 0, ag = 0, v = 0;
  long long idx = -1;
  if (tid < m) {
    ctr = load_now(counter + ip);
    ag = load_now(age + ip);
    v = load_now(valid + ip);
    idx = load_now(match_idx + ip);
  }
  float x = 0.0f, y = 0.0f, z = 0.0f;
  int sv = 0;
  if (tid < n) {
    x = load_now(spos + 3 * is);
    y = load_now(spos + 3 * is + 1);
    z = load_now(spos + 3 * is + 2);
    sv = load_now(svalid + is);
  }
  // the two features' claim (bits 0, 2) and validity (bits 1, 3)
  int fbits = 0;
#pragma unroll
  for (int t = 0, f = tid; t < 2; ++t, f += THREADS)
    if (f < k)
      fbits |= ((load_now(fm + s * k + f) != 0) |
                (load_now(fvalid + s * k + f) != 0) << 1) << 2 * t;
  // PnP's pose, the identity on the init frame
  const bool init = load_now(is_init + s) != 0;
  float po[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const float pnp = load_now(i < 3 ? pt + 3 * s + i : pq + 4 * s + i - 3);
    po[i] = init ? (i == 3 ? 1.0f : 0.0f) : pnp;
  }
  __syncthreads();   // 1: the un-marks cleared
  TRACK_CLOCK(51);
  float r[9], tw[3];
  world_to_camera(po, po + 3, r, tw);
  if (tid == 0)
    for (int i = 0; i < 7; ++i) pose_out[7 * s + i] = po[i];
  const Kept own = bookkeep(ctr, ag, v != 0, idx, threshold, k);
  int kept = tid < m && own.stays;
  if (tid < m && own.unmark >= 0) unmark[own.unmark] = 1;
  const Seen seen = project_staged(r, tw, x, y, z, sv != 0, cam);
#pragma unroll 2
  for (int p = tid + THREADS; p < m; p += THREADS) {
    const long long i = s * m + p;
    const Kept o = bookkeep(counter[i], age[i], valid[i] != 0, match_idx[i],
                            threshold, k);
    counter_out[i] = o.counter;
    age_out[i] = o.age;
    valid_out[i] = o.stays;
    kept += o.stays;
    if (o.unmark >= 0) unmark[o.unmark] = 1;
  }
#pragma unroll 2
  for (int p = tid + THREADS; p < n; p += THREADS) {
    const long long i = s * n + p;
    const Seen o = project_staged(r, tw, spos[3 * i], spos[3 * i + 1],
                                  spos[3 * i + 2], svalid[i] != 0, cam);
    suv[2 * i] = o.u;
    suv[2 * i + 1] = o.v;
    svis[i] = o.vis;
  }
  const int size = block_sum2(kept, 0, warp_sums).x;   // 2: the un-marks set
  TRACK_CLOCK(52);
  if (tid < m) {
    counter_out[ip] = own.counter;
    age_out[ip] = own.age;
    valid_out[ip] = own.stays;
  }
  if (tid < n) {
    suv[2 * is] = seen.u;
    suv[2 * is + 1] = seen.v;
    svis[is] = seen.vis;
  }
  // the claims less the un-marked, and the staged match's targets
#pragma unroll
  for (int t = 0, f = tid; t < 2; ++t, f += THREADS) {
    if (f >= k) break;
    const bool claimed = (fbits >> 2 * t & 1) && !unmark[f];
    fm_out[s * k + f] = claimed;
    targets[s * k + f] = (fbits >> 2 * t & 2) && !claimed;
  }
  if (tid == 0) map_size[s] = size;
  TRACK_CLOCK(59);
}

// ---- K3 and K4: one thread-block cluster per stream
//
// Grid (C, S), a cluster of the C blocks of a stream (launched with the
// cluster dimension as an attribute: C is the wrapper's choice). Block rank
// r owns one contiguous range of each axis (range_of): of the queries (K
// features, or N staged points), of the resolution's K + 1 targets, and of
// the map's and the staged set's slots. Every integer the kernels exchange
// is a count or a prefix in index order, so the insertion order and every
// bit of the outputs are those of one block walking the axes in order.

struct Top2 {
  const float* d1;
  const float* d2;
  const long long* best;
  const long long* n_cand;
};

// The contiguous range of an axis of n that block `r` of `c` owns
struct Range {
  int lo, hi, per;
};

__host__ __device__ __forceinline__ int per_block(int n, int c) {
  return (n + c - 1) / c;
}

__device__ __forceinline__ Range range_of(int n, int c, int r) {
  const int per = per_block(n, c);
  const int lo = min(n, r * per);
  return Range{lo, min(n, lo + per), per};
}

// A split cluster barrier: arrive (releasing this thread's writes, to
// shared and to global memory, at cluster scope), then wait (acquiring
// every other thread's of the cluster). Every thread of every block calls
// both, in turn.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// An arrive that orders no memory: for the last barrier, which only keeps
// a block's shared memory alive until the others have read it (their reads
// are complete: each thread used the values before it arrived)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// The exclusive prefix over the cluster's ranks of each of the N counts
// each block published (pub[j]), into pre[j][0..c] (pre[j][c]: the
// cluster's total), by warp 0; the caller syncs the block after it
template <int N>
__device__ void rank_prefix(cg::cluster_group& cluster, int c, int* pub,
                            int (*pre)[CLUSTER_MAX + 1]) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int v = lane < c ? *cluster.map_shared_rank(pub + j, lane) : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += up;
    }
    if (lane <= c) pre[j][lane] = incl - v;
  }
}

// A descriptor's 8 words: two 16-byte loads where the row is aligned (the
// rows of an input whose base is), else word by word
__device__ __forceinline__ void load_desc(const int* p, int* d) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const int4 a = reinterpret_cast<const int4*>(p)[0];
    const int4 b = reinterpret_cast<const int4*>(p)[1];
    d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
    d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
  } else {
#pragma unroll
    for (int w = 0; w < DESC_WORDS; ++w) d[w] = p[w];
  }
}

// A descriptor row of an output: the wrapper allocates the outputs, so
// their 32-byte rows are 16-byte aligned
__device__ __forceinline__ void store_desc(int* p, const int* d) {
  reinterpret_cast<int4*>(p)[0] = make_int4(d[0], d[1], d[2], d[3]);
  reinterpret_cast<int4*>(p)[1] = make_int4(d[4], d[5], d[6], d[7]);
}

// The pass-through copy of slot p of a store, issued with the kernel's
// other loads (its stores wait for the loads they all wait for); the slots
// taken are written again after barrier 3, which orders the two
__device__ __forceinline__ void copy_slot(Store in, StoreOut out, int p) {
  int d[DESC_WORDS];
  load_desc(in.desc + DESC_WORDS * p, d);
  const float x = in.pos[3 * p], y = in.pos[3 * p + 1], z = in.pos[3 * p + 2];
  const int ctr = in.counter[p], age = in.age[p];
  store_desc(out.desc + DESC_WORDS * p, d);
  out.pos[3 * p] = x;
  out.pos[3 * p + 1] = y;
  out.pos[3 * p + 2] = z;
  out.counter[p] = ctr;
  out.age[p] = age;
}

// An insertion's record of one new point in its owner's shared memory,
// REC words: the descriptor [0, 8), the position [8, 11), the counter, the
// age, 16-byte aligned (read by another block as four vectors)
constexpr int REC = 16;

// The local free ranks of the block's slots [r.lo, r.hi) of a store in
// index order (free_rank[i], -1 where the slot holds a point; the validity
// kept in val[i]); returns the block's free slots. Every thread calls it.
__device__ int rank_free(const uint8_t* val, int n_slots, int* free_rank,
                         int* warp_sums) {
  int carry = 0;
  for (int base = 0; base < n_slots; base += CLUSTER_THREADS) {
    const int i = base + threadIdx.x;
    const bool free_slot = i < n_slots && !val[i];
    int total;
    const int r = block_rank(free_slot, warp_sums, total);
    if (i < n_slots) free_rank[i] = free_slot ? carry + r : -1;
    carry += total;
  }
  return carry;
}

// insert_points on the block's slots [r.lo, r.hi) of one stream's store:
// a free slot of global free rank g < n_new takes the new point of global
// candidate rank g, its record read out of its owner's shared memory (the
// owner: the rank whose candidates' prefix cand_pre holds g); every slot's
// validity, and `taken` (may be null). The other slots keep their
// pass-through copy (copy_slot).
__device__ void insert_slots(cg::cluster_group& cluster, int c,
                             const Range& r, const int* free_rank,
                             const uint8_t* val, int free_before,
                             const int* cand_pre, int n_new, int* recs,
                             StoreOut out, uint8_t* taken) {
  for (int i = threadIdx.x; i < r.hi - r.lo; i += CLUSTER_THREADS) {
    const int g = free_before + free_rank[i];
    const bool take = free_rank[i] >= 0 && g < n_new;
    const int p = r.lo + i;
    if (take) {
      int o = 0;
      while (o + 1 < c && cand_pre[o + 1] <= g) ++o;
      const int4* src = reinterpret_cast<const int4*>(
          cluster.map_shared_rank(recs, o) + REC * (g - cand_pre[o]));
      const int4 d0 = src[0], d1 = src[1], pc = src[2], ag = src[3];
      const int d[DESC_WORDS] = {d0.x, d0.y, d0.z, d0.w,
                                 d1.x, d1.y, d1.z, d1.w};
      store_desc(out.desc + DESC_WORDS * p, d);
      out.pos[3 * p] = __int_as_float(pc.x);
      out.pos[3 * p + 1] = __int_as_float(pc.y);
      out.pos[3 * p + 2] = __int_as_float(pc.z);
      out.counter[p] = pc.w;
      out.age[p] = ag.x;
    }
    out.valid[p] = val[i] || take;
    if (taken) taken[p] = take;
  }
}

// The owner of target t (of the K + 1) and t's place in its key array
__device__ __forceinline__ int* target_key(cg::cluster_group& cluster,
                                           int* key, int per, int t) {
  const int o = t / per;
  return cluster.map_shared_rank(key, o) + (t - o * per);
}

// ---- K3

// Dynamic shared memory of staged_promote_kernel (the carving below)
__host__ __device__ inline size_t staged_smem(int n, int m, int k, int c) {
  const size_t q = per_block(n, c), t = per_block(k + 1, c),
               s = per_block(m, c);
  return 4 * (REC * q + t + 3 * q + s) + t + s + q;
}

// Block rank r: its staged queries' acceptance (their target and key),
// counters, validity and rows (the promotions' records), its targets'
// keys and claims, its map slots' validity and free ranks are loaded at
// once, and its map slots copied through. Exchange 1 (cluster barrier 1):
// the keys are set. Each accepted query's key goes to its target's owner
// (atomicMin over distributed shared memory: a minimum, whatever the
// order). Exchange 2: a query won its target where the owner's key is its
// own; the claims go to the owners; the promotions are compacted in index
// order (block_rank), and the free slots' counts read. Exchange 3: each
// block reads the ranks' promotion counts and fills its free slots of
// global rank below their total from the owners' records. Exchange 4: no
// block leaves while another may read its shared memory.
__global__ void __launch_bounds__(CLUSTER_THREADS) staged_promote_kernel(
    Top2 top2, Store staged, const uint8_t* __restrict__ fm,
    const long long* __restrict__ map_size, Store map, int n, int m, int k,
    float ratio, float abs_th, int staged_threshold, int soft_cap,
    int* __restrict__ sctr_out, uint8_t* __restrict__ svalid_out,
    uint8_t* __restrict__ fm_out, StoreOut map_out,
    uint8_t* __restrict__ taken) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long s = blockIdx.y;
  const Range rq = range_of(n, c, rank), rt = range_of(k + 1, c, rank),
              rm = range_of(m, c, rank);
  const int nq = rq.hi - rq.lo, nt = rt.hi - rt.lo, nm = rm.hi - rm.lo;
  extern __shared__ int4 dyn[];
  int* recs = reinterpret_cast<int*>(dyn);   // [per q][REC]
  int* key = recs + REC * rq.per;            // [per t], read by the cluster
  int* qidx = key + rt.per;                  // [per q] accepted target or -1
  int* qkey = qidx + rq.per;                 // [per q]
  int* qctr = qkey + rq.per;                 // [per q]
  int* mfree = qctr + rq.per;                // [per m]
  uint8_t* claims = reinterpret_cast<uint8_t*>(mfree + rm.per);   // [per t]
  uint8_t* mval = claims + rt.per;           // [per m]
  uint8_t* qval = mval + rm.per;             // [per q]
  __shared__ int warp_sums[CLUSTER_WARPS];
  __shared__ int pub[2];   // free map slots, promotions: read by the cluster
  __shared__ int pre[2][CLUSTER_MAX + 1];
  const int tid = threadIdx.x;

  TRACK_CLOCK(10);
  for (int i = tid; i < nt; i += CLUSTER_THREADS) key[i] = IMAX;
  cluster_arrive();   // 1: the keys are set before any block's atomicMin
  TRACK_CLOCK(11);
  const Top2 t2{top2.d1 + s * n, top2.d2 + s * n, top2.best + s * n,
                top2.n_cand + s * n};
  const Store st = offset(staged, s * n), mp = offset(map, s * m);
  const StoreOut mo = offset(map_out, s * m);
  const int most = max(max(nq, nt), nm);
  for (int i = tid; i < most; i += CLUSTER_THREADS) {
    if (i < nq) {
      const int q = rq.lo + i;
      const float d1 = t2.d1[q];
      const long long idx =
          accept(d1, t2.d2[q], t2.best[q], t2.n_cand[q], ratio, abs_th);
      int* r = recs + REC * i;
      load_desc(st.desc + DESC_WORDS * q, r);
      r[8] = __float_as_int(st.pos[3 * q]);
      r[9] = __float_as_int(st.pos[3 * q + 1]);
      r[10] = __float_as_int(st.pos[3 * q + 2]);
      r[12] = st.age[q];
      qctr[i] = st.counter[q];
      qval[i] = st.valid[q];
      qidx[i] = static_cast<int>(idx);
      qkey[i] = resolve_key(d1, q, n);
    }
    if (i < nt && rt.lo + i < k) claims[i] = fm[s * k + rt.lo + i];
    if (i < nm) {
      mval[i] = mp.valid[rm.lo + i];
      copy_slot(mp, mo, rm.lo + i);
    }
  }
  const int n_free = rank_free(mval, nm, mfree, warp_sums);
  if (tid == 0) pub[0] = n_free;
  const bool small_map = map_size[s] < soft_cap;
  TRACK_CLOCK(12);
  cluster_wait();
  TRACK_CLOCK(13);
  // the resolution: each accepted query's key to its target's owner
  for (int i = tid; i < nq; i += CLUSTER_THREADS)
    if (qidx[i] >= 0)
      atomicMin(target_key(cluster, key, rt.per, qidx[i]), qkey[i]);
  cluster_arrive();   // 2: the keys are final, the free counts published
  TRACK_CLOCK(14);
  cluster_wait();
  TRACK_CLOCK(15);
  rank_prefix<1>(cluster, c, pub, pre);
  // the promotion flags, the claims to their owners, the staged outputs
  // (kept in qctr, qval and stored after barrier 3's arrive: its release
  // would wait for global stores), and the promotions' records compacted
  // in place in index order (a record moves to its rank, never above its
  // own index: each pass reads its records before block_rank's first
  // barrier)
  int carry = 0;
  for (int base = 0; base < nq; base += CLUSTER_THREADS) {
    const int i = base + tid;
    bool promote = false;
    int r[13];
    if (i < nq) {
      const int idx = qidx[i];
      bool matched = false;
      if (idx >= 0) {
        matched = *target_key(cluster, key, rt.per, idx) == qkey[i];
        if (matched) {
          const int o = idx / rt.per;
          *cluster.map_shared_rank(claims + (idx - o * rt.per), o) = 1;
        }
      }
      const int cnt = qctr[i];
      const bool v = qval[i];
      promote = v && matched && (cnt + 1 == staged_threshold || small_map);
      qctr[i] = matched ? cnt + 1 : cnt;
      qval[i] = v && matched && !promote;
      if (promote) {
#pragma unroll
        for (int w = 0; w < 11; ++w) r[w] = recs[REC * i + w];
        r[11] = cnt + 1;
        r[12] = recs[REC * i + 12];
      }
    }
    int total;
    const int at = carry + block_rank(promote, warp_sums, total);
    if (promote) {
#pragma unroll
      for (int w = 0; w < 13; ++w) recs[REC * at + w] = r[w];
    }
    carry += total;
  }
  if (tid == 0) pub[1] = carry;
  TRACK_CLOCK(16);
  cluster_arrive();   // 3: claims, records and promotion counts
  for (int i = tid; i < nq; i += CLUSTER_THREADS) {
    sctr_out[s * n + rq.lo + i] = qctr[i];
    svalid_out[s * n + rq.lo + i] = qval[i];
  }
  cluster_wait();
  TRACK_CLOCK(17);
  rank_prefix<1>(cluster, c, pub + 1, pre + 1);
  for (int i = tid; i < nt; i += CLUSTER_THREADS)
    if (rt.lo + i < k) fm_out[s * k + rt.lo + i] = claims[i];
  __syncthreads();
  insert_slots(cluster, c, rm, mfree, mval, pre[0][rank], pre[1],
               pre[1][c], recs, mo, taken + s * m);
  TRACK_CLOCK(18);
  cluster_arrive_relaxed();   // 4: no block leaves while another reads its
  cluster_wait();             // shared memory
  TRACK_CLOCK(19);
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

// Dynamic shared memory of triangulate_insert_kernel (the carving below)
__host__ __device__ inline size_t tri_smem(int k, int m, int n, int rgbd,
                                           int c) {
  const size_t f = per_block(k, c), t = rgbd ? 0 : per_block(k + 1, c),
               a = per_block(m, c), b = per_block(n, c);
  return 4 * (REC * f + t + 6 * f + a + b) + a + b + f;
}

// Block rank r: its features' acceptance (target and key), keypoints, the
// right keypoint of their best match (and feature 0's: a query that loses
// its target pairs with it), descriptors (the candidates' records), depth
// and validity (RGB-D), its targets' keys, the map's and the staged set's
// slots' validity and free ranks are loaded at once, and the slots copied
// through. Exchange 1: the keys are set; each accepted query's key goes to
// its target's owner (atomicMin over distributed shared memory). Exchange
// 2: the map's size (the ranks' valid counts) sets the policy and the
// split; each block triangulates its features (triangulate_pair, the
// plain version's operations in its order) or back-projects them, writes
// their world points and candidate flags, and compacts its candidates'
// records in index order. Exchange 3: each block fills its free slots of
// the store that takes the candidates (to_map: the map, else the staged
// set) from the owners' records. Exchange 4: no block leaves while another
// may read its records. Rank 0 writes the stream's scalars.
__global__ void __launch_bounds__(CLUSTER_THREADS) triangulate_insert_kernel(
    Top2 top2, Features feats, int k, int rgbd, const float* __restrict__ pt,
    const float* __restrict__ pq, Store map, int m, Store staged, int n,
    const float* __restrict__ last_matches,
    const long long* __restrict__ matches_count,
    const uint8_t* __restrict__ is_init, TriParams prm, StoreOut map_out,
    uint8_t* __restrict__ map_taken, StoreOut staged_out,
    long long* __restrict__ n_inserted, long long* __restrict__ map_size_out,
    float* __restrict__ window_out, float* __restrict__ pts,
    uint8_t* __restrict__ cand) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long s = blockIdx.y;
  const Range rf = range_of(k, c, rank),
              rt = range_of(rgbd ? 0 : k + 1, c, rank),
              rm = range_of(m, c, rank), rn = range_of(n, c, rank);
  const int nf = rf.hi - rf.lo, nt = rt.hi - rt.lo, nm = rm.hi - rm.lo,
            nn = rn.hi - rn.lo;
  extern __shared__ int4 dyn[];
  int* recs = reinterpret_cast<int*>(dyn);   // [per f][REC]
  int* key = recs + REC * rf.per;            // [per t], read by the cluster
  int* fidx = key + rt.per;                  // [per f] accepted target or -1
  int* fkey = fidx + rf.per;                 // [per f]
  float* fkp = reinterpret_cast<float*>(fkey + rf.per);   // [per f][4]
  int* mfree = reinterpret_cast<int*>(fkp + 4 * rf.per);  // [per m]
  int* nfree = mfree + rm.per;               // [per n]
  uint8_t* mval = reinterpret_cast<uint8_t*>(nfree + rn.per);   // [per m]
  uint8_t* nval = mval + rm.per;             // [per n]
  uint8_t* fok = nval + rn.per;              // [per f] (RGB-D)
  __shared__ int warp_sums[CLUSTER_WARPS];
  // valid map slots, free map slots, free staged slots, candidates: read
  // by the cluster
  __shared__ int pub[4];
  __shared__ int pre[4][CLUSTER_MAX + 1];
  __shared__ float rot[9], rkp0[2];
  const int tid = threadIdx.x;
  const long long o = s * k;

  TRACK_CLOCK(0);
  for (int i = tid; i < nt; i += CLUSTER_THREADS) key[i] = IMAX;
  cluster_arrive();   // 1: the keys are set before any block's atomicMin
  TRACK_CLOCK(1);
  const Top2 t2{top2.d1 + o, top2.d2 + o, top2.best + o, top2.n_cand + o};
  const Store mp = offset(map, s * m), sp = offset(staged, s * n);
  const StoreOut mo = offset(map_out, s * m), so = offset(staged_out, s * n);
  if (tid == 0) {
    to_matrix(pq + 4 * s, rot);
    if (!rgbd && k > 0) {
      rkp0[0] = feats.rkp[2 * o];
      rkp0[1] = feats.rkp[2 * o + 1];
    }
  }
  const int most = max(max(nf, nm), nn);
  for (int i = tid; i < most; i += CLUSTER_THREADS) {
    if (i < nf) {
      const long long f = o + rf.lo + i;
      float* kp4 = fkp + 4 * i;
      kp4[0] = feats.kp[2 * f];
      kp4[1] = feats.kp[2 * f + 1];
      load_desc(feats.desc + DESC_WORDS * f, recs + REC * i);
      if (rgbd) {
        kp4[2] = feats.depth[f];
        fok[i] = feats.valid[f];
      } else {
        const int q = rf.lo + i;
        const float d1 = t2.d1[q];
        const long long best = t2.best[q];
        fidx[i] = static_cast<int>(
            accept(d1, t2.d2[q], best, t2.n_cand[q], prm.ratio, prm.abs_th));
        fkey[i] = resolve_key(d1, q, k);
        // the right keypoint of the match, if it resolves
        const long long r = best < 0 ? 0 : (best > k - 1 ? k - 1 : best);
        kp4[2] = feats.rkp[2 * (o + r)];
        kp4[3] = feats.rkp[2 * (o + r) + 1];
      }
    }
    if (i < nm) {
      mval[i] = mp.valid[rm.lo + i];
      copy_slot(mp, mo, rm.lo + i);
    }
    if (i < nn) {
      nval[i] = sp.valid[rn.lo + i];
      copy_slot(sp, so, rn.lo + i);
    }
  }
  const int map_free = rank_free(mval, nm, mfree, warp_sums);
  const int staged_free = rank_free(nval, nn, nfree, warp_sums);
  if (tid == 0) {
    pub[0] = nm - map_free;
    pub[1] = map_free;
    pub[2] = staged_free;
  }
  // the stream's scalars, read before the exchanges too
  const bool init = is_init[s] != 0;
  const float window[3] = {last_matches[3 * s + 1], last_matches[3 * s + 2],
                           static_cast<float>(matches_count[s])};
  const float t[3] = {pt[3 * s], pt[3 * s + 1], pt[3 * s + 2]};
  TRACK_CLOCK(2);
  cluster_wait();
  TRACK_CLOCK(3);
  // the row resolution: each accepted query's key to its target's owner
  if (!rgbd)
    for (int i = tid; i < nf; i += CLUSTER_THREADS)
      if (fidx[i] >= 0)
        atomicMin(target_key(cluster, key, rt.per, fidx[i]), fkey[i]);
  cluster_arrive();   // 2: the keys are final, the counts published
  TRACK_CLOCK(4);
  cluster_wait();
  TRACK_CLOCK(5);
  rank_prefix<3>(cluster, c, pub, pre);
  __syncthreads();
  // the map's size, the policy and the split (uniform over the cluster)
  const int map_size = pre[0][c];
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
  // each feature's point and candidate flag (kept in fkp, fok and stored
  // after barrier 3's arrive, as staged_promote_kernel's outputs); the
  // candidates' records compacted in place in index order (as there)
  int carry = 0;
  for (int base = 0; base < nf; base += CLUSTER_THREADS) {
    const int i = base + tid;
    bool take = false;
    float w[3];
    int d[DESC_WORDS];
    if (i < nf) {
      float* kp4 = fkp + 4 * i;
      const float ul = kp4[0], vl = kp4[1];
      float pc[3];
      bool ok;
      if (rgbd) {
        const float dp = kp4[2];
        pc[0] = __fdiv_rn(__fmul_rn(__fsub_rn(ul, prm.cam.cx), dp),
                          prm.cam.fx);
        pc[1] = __fdiv_rn(__fmul_rn(__fsub_rn(vl, prm.cam.cy), dp),
                          prm.cam.fy);
        pc[2] = dp;
        ok = fok[i];
      } else {
        const int idx = fidx[i];
        const bool won =
            idx >= 0 && *target_key(cluster, key, rt.per, idx) == fkey[i];
        // a query that lost its target pairs with feature 0 (the clamp of
        // -1), as the plain version's gather does
        ok = triangulate_pair(ul, vl, won ? kp4[2] : rkp0[0],
                              won ? kp4[3] : rkp0[1], won, prm, pc);
      }
      // the world point: matvec(R, p) + t
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        w[j] = __fadd_rn(mv(rot, j, pc[0], pc[1], pc[2]), t[j]);
        kp4[j] = w[j];
      }
      take = ok && need_tri;
      fok[i] = take;
      if (take) {
#pragma unroll
        for (int j = 0; j < DESC_WORDS; ++j) d[j] = recs[REC * i + j];
      }
    }
    int total;
    const int at = carry + block_rank(take, warp_sums, total);
    if (take) {
      int* r = recs + REC * at;
#pragma unroll
      for (int j = 0; j < DESC_WORDS; ++j) r[j] = d[j];
#pragma unroll
      for (int j = 0; j < 3; ++j) r[8 + j] = __float_as_int(w[j]);
      r[11] = 0;
      r[12] = 0;
    }
    carry += total;
  }
  if (tid == 0) pub[3] = carry;
  TRACK_CLOCK(6);
  cluster_arrive();   // 3: the records and the candidate counts
  for (int i = tid; i < 3 * nf; i += CLUSTER_THREADS)
    pts[3 * (o + rf.lo) + i] = fkp[4 * (i / 3) + i % 3];
  for (int i = tid; i < nf; i += CLUSTER_THREADS) cand[o + rf.lo + i] = fok[i];
  cluster_wait();
  TRACK_CLOCK(7);
  rank_prefix<1>(cluster, c, pub + 3, pre + 3);
  __syncthreads();
  const int n_new = pre[3][c];
  const int to_map_n = to_map ? n_new : 0, to_staged_n = to_map ? 0 : n_new;
  insert_slots(cluster, c, rm, mfree, mval, pre[1][rank], pre[3], to_map_n,
               recs, mo, map_taken + s * m);
  insert_slots(cluster, c, rn, nfree, nval, pre[2][rank], pre[3],
               to_staged_n, recs, so, nullptr);
  TRACK_CLOCK(8);
  cluster_arrive_relaxed();   // 4: no block leaves while another reads its
                              // shared memory
  if (rank == 0 && tid == 0) {
    // insert_points' count: the free slots filled, at most the new points
    const int in_map = min(pre[1][c], to_map_n);
    const int in_staged = min(pre[2][c], to_staged_n);
    const int size = map_size + in_map;
    n_inserted[s] = in_map + in_staged;
    map_size_out[s] = size;
    window_out[3 * s] = init ? static_cast<float>(size) : window[0];
    window_out[3 * s + 1] = init ? prm.window_init : window[1];
    window_out[3 * s + 2] = init ? prm.window_init : window[2];
  }
  cluster_wait();
  TRACK_CLOCK(9);
}

// ---- K5

// One query's match at radius r (0 narrow, 1 wide) from T's outputs (f, g:
// the stream's fout and iout): its distances and its accepted target (-1 if
// rejected)
struct Match {
  float d1, d2;
  long long idx;
};

__device__ __forceinline__ Match load_match(const float* f, const long long* g,
                                            int m, int q, int r, float ratio,
                                            float abs_th) {
  const float d1 = f[r * m + q], d2 = f[(2 + r) * m + q];
  return Match{d1, d2, accept(d1, d2, g[r * m + q], g[(2 + r) * m + q], ratio,
                              abs_th)};
}

// PnP's observation of a query matched to target idx (clamped as the
// plain version's gather clamps), feature 0's where unmatched (idx < 0),
// from the stream's keypoints staged in shared memory
__device__ __forceinline__ float2 keypoint(const float2* kp_s, long long idx,
                                           int k) {
  if (k < 1) return make_float2(0.0f, 0.0f);
  return kp_s[idx < 0 ? 0 : static_cast<int>(idx > k - 1 ? k - 1 : idx)];
}

// The map match after kernel T (ops/matching.py::match_projected) and the
// step's glue before PnP: each radius's acceptance and one-to-one
// resolution, the wide radius where the narrow one resolved fewer than
// retry_min, the match index (-2 invisible, -1 unmatched), the distances
// of the radius used, the claims of the valid features, the count, and
// PnP's observations (the matched feature's keypoint, feature 0's where
// unmatched) and weights. T's outputs as it writes them: fout [S, 2 (d1,
// d2), 2 (narrow, wide), M] f32, iout [S, 2 (best, n_cand), 2, M] int64.
//
// One block per stream. Before the first barrier each thread loads its
// query at both radii and its visibility, and stages its two features'
// keypoints and validity in shared memory: one round trip, no load waiting
// on another (PnP's observation is read from the staged keypoints). A key
// encodes its query (distance x (M + 1) + index: unique for T's
// distances), so a target has a winner exactly where its key is set: each
// radius's count is the number of atomicMins that found their target's key
// unset (targets 0..K, K the slot of a best of K), and the claims are read
// from the keys. Two barriers: keys set; matches resolved, with the warp
// sums of the two counts. Further tiles of THREADS queries (M > THREADS)
// load in the resolution pass and again, the radius used, in the outputs'.
__global__ void __launch_bounds__(THREADS) map_accept_kernel(
    const float* __restrict__ fout, const long long* __restrict__ iout,
    const uint8_t* __restrict__ visible, const uint8_t* __restrict__ fvalid,
    const float* __restrict__ kp, int m, int k, float ratio, float abs_th,
    int retry_min, long long* __restrict__ match_idx,
    float* __restrict__ d1_out, float* __restrict__ d2_out,
    uint8_t* __restrict__ fm_out, long long* __restrict__ count_out,
    uint8_t* __restrict__ wide_out, float2* __restrict__ obs,
    float* __restrict__ weights) {
  // best_key of each radius [2][k + 1], the keypoints [k] and the
  // features' validity [k]
  extern __shared__ int keys[];
  int* const key_a = keys;
  int* const key_b = keys + k + 1;
  float2* const kp_s = reinterpret_cast<float2*>(keys + 2 * (k + 1));
  uint8_t* const fv_s = reinterpret_cast<uint8_t*>(kp_s + k);
  __shared__ int2 warp_sums[WARPS];
  const long long s = blockIdx.x;
  const int tid = threadIdx.x;
  const float* f = fout + 4 * s * m;
  const long long* g = iout + 4 * s * m;
  TRACK_CLOCK(40);
  for (int j = tid; j <= k; j += THREADS) key_a[j] = key_b[j] = IMAX;
  Match a{0.0f, 0.0f, -1}, b{0.0f, 0.0f, -1};
  bool vis = false;
  if (tid < m) {
    a = load_match(f, g, m, tid, 0, ratio, abs_th);
    b = load_match(f, g, m, tid, 1, ratio, abs_th);
    vis = visible[s * m + tid] != 0;
  }
  // the thread's two features loaded together, then staged
  float2 kq[2];
  bool fq[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const long long i = s * k + tid + t * THREADS;
    if (tid + t * THREADS < k) {
      kq[t] = make_float2(kp[2 * i], kp[2 * i + 1]);
      fq[t] = fvalid[i] != 0;
    }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (tid + t * THREADS < k) {
      kp_s[tid + t * THREADS] = kq[t];
      fv_s[tid + t * THREADS] = fq[t];
    }
  }
  __syncthreads();   // 1: the keys set, the features staged
  TRACK_CLOCK(41);
  const int ka = resolve_key(a.d1, tid, m), kb = resolve_key(b.d1, tid, m);
  int na = 0, nb = 0;
  if (a.idx >= 0) na += atomicMin(&key_a[a.idx], ka) == IMAX;
  if (b.idx >= 0) nb += atomicMin(&key_b[b.idx], kb) == IMAX;
#pragma unroll 2
  for (int q = tid + THREADS; q < m; q += THREADS) {
    const Match x = load_match(f, g, m, q, 0, ratio, abs_th);
    const Match y = load_match(f, g, m, q, 1, ratio, abs_th);
    if (x.idx >= 0)
      na += atomicMin(&key_a[x.idx], resolve_key(x.d1, q, m)) == IMAX;
    if (y.idx >= 0)
      nb += atomicMin(&key_b[y.idx], resolve_key(y.d1, q, m)) == IMAX;
  }
  const int2 won = block_sum2(na, nb, warp_sums);   // 2: matches resolved
  TRACK_CLOCK(42);
  const bool wide = won.x < retry_min;
  const int* key_u = wide ? key_b : key_a;
  if (tid < m) {
    const long long idx = wide ? b.idx : a.idx;
    const bool ok = idx >= 0 && key_u[idx] == (wide ? kb : ka);
    const long long at = s * m + tid;
    const long long mi = vis ? (ok ? idx : -1) : -2;
    match_idx[at] = mi;
    d1_out[at] = wide ? b.d1 : a.d1;
    d2_out[at] = wide ? b.d2 : a.d2;
    obs[at] = keypoint(kp_s, mi, k);
    weights[at] = mi >= 0 ? 1.0f : 0.0f;
  }
#pragma unroll 2
  for (int q = tid + THREADS; q < m; q += THREADS) {
    const Match u = load_match(f, g, m, q, wide, ratio, abs_th);
    const bool ok = u.idx >= 0 && key_u[u.idx] == resolve_key(u.d1, q, m);
    const long long at = s * m + q;
    const long long mi = visible[at] ? (ok ? u.idx : -1) : -2;
    match_idx[at] = mi;
    d1_out[at] = u.d1;
    d2_out[at] = u.d2;
    obs[at] = keypoint(kp_s, mi, k);
    weights[at] = mi >= 0 ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int t = 0, j = tid; t < 2; ++t, j += THREADS)
    if (j < k) fm_out[s * k + j] = key_u[j] != IMAX && fv_s[j];
  if (tid == 0) {
    count_out[s] = wide ? won.y : won.x;
    wide_out[s] = wide;
  }
  TRACK_CLOCK(49);
}

// ---- K6

// The BA row match and the window's slide (core/track.py::
// ba_observe_plain). T's outputs as it writes them (fout [S, 2, 2, K],
// iout [S, 2, 2, K]; the second predicate is the BA row set, the
// map-matched left features, so load_match's radius index 1 reads it).
//
// Grid (1 + copy blocks, S). Block 0 of a stream: before the first barrier
// each thread clears its targets' keys, loads its two queries' top-2 and
// accepts them, stages its two right keypoints in shared memory and loads
// its map slot's match, observation, weight and the five masks of its
// liveness; it also copies the window's poses (the oldest dropped, PnP's
// pose appended). Between the barriers each accepted query takes an
// atomicMin of its key (distance x (K + 1) + index, unique) at its target
// and leaves its target and key in shared memory. After the second a map
// slot's right index is its feature's target where the feature's key won
// (-1 elsewhere), its observation the right keypoint there (clamped as
// the plain version's gathers clamp), and the window's newest row is
// written with the weights times the slot's liveness (a product with 1 or
// 0, as the plain version's). Without a right camera (K = 0) the right
// observations and weights are zero. The copy blocks move the F - 1 older
// rows down by one, a (row, slot) item a thread, weights times liveness.
__global__ void __launch_bounds__(THREADS) ba_observe_kernel(
    const float* __restrict__ fout, const long long* __restrict__ iout,
    const long long* __restrict__ match_idx, const float2* __restrict__ obs,
    const float* __restrict__ weights, const float2* __restrict__ rkp,
    const float* __restrict__ t, const float* __restrict__ q,
    const float* __restrict__ poses_t, const float* __restrict__ poses_q,
    const float2* __restrict__ w_obs, const float* __restrict__ w_w,
    const float2* __restrict__ w_obs_r, const float* __restrict__ w_w_r,
    const int* __restrict__ n_in, const uint8_t* __restrict__ mvalid,
    const uint8_t* __restrict__ bvalid, const uint8_t* __restrict__ cvalid,
    const uint8_t* __restrict__ taken, const uint8_t* __restrict__ ptaken,
    const int* __restrict__ frame, int k, int m, int f, float ratio,
    float abs_th, int every, float* __restrict__ poses_t_out,
    float* __restrict__ poses_q_out, float2* __restrict__ obs_out,
    float* __restrict__ w_out, float2* __restrict__ obs_r_out,
    float* __restrict__ w_r_out, int* __restrict__ n_out,
    uint8_t* __restrict__ do_ba) {
  const long long s = blockIdx.y;
  const long long fm = static_cast<long long>(f) * m;
  const long long wb = s * fm;   // the stream's window rows
  const int tid = threadIdx.x;
  // a slot is alive where the map holds it after the insertions and
  // nothing culled or recycled it this frame
  auto alive = [&](int j) {
    const long long i = s * m + j;
    const bool removed = bvalid[i] && !cvalid[i];
    const bool recycled = taken[i] || (ptaken != nullptr && ptaken[i]);
    return mvalid[i] && !(removed || recycled) ? 1.0f : 0.0f;
  };
  if (blockIdx.x > 0) {
    // the older rows: row r + 1 of the window becomes row r
    const long long items = static_cast<long long>(f - 1) * m;
    for (long long i = static_cast<long long>(blockIdx.x - 1) * THREADS + tid;
         i < items; i += static_cast<long long>(gridDim.x - 1) * THREADS) {
      const int j = static_cast<int>(i % m);
      const long long from = wb + i + m, to = wb + i;
      const float2 o = w_obs[from], o_r = w_obs_r[from];
      const float w = w_w[from], w_r = w_w_r[from];
      const float a = alive(j);
      obs_out[to] = o;
      obs_r_out[to] = o_r;
      w_out[to] = __fmul_rn(w, a);
      w_r_out[to] = __fmul_rn(w_r, a);
    }
    return;
  }
  // the right keypoints [k], the key of each target [k + 1], each query's
  // accepted target and key [k]
  extern __shared__ float2 rkp_s[];
  int* const keys = reinterpret_cast<int*>(rkp_s + k);
  int* const q_idx = keys + k + 1;
  int* const q_key = q_idx + k;
  const float* fo = fout + 4 * s * k;
  const long long* io = iout + 4 * s * k;
  TRACK_CLOCK(60);
  for (int j = tid; j <= k; j += THREADS) keys[j] = IMAX;
  Match mq[2];
  float2 kq[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int qi = tid + u * THREADS;
    mq[u] = Match{0.0f, 0.0f, -1};
    if (qi < k) {
      mq[u] = load_match(fo, io, k, qi, 1, ratio, abs_th);
      kq[u] = rkp[s * k + qi];
    }
  }
  long long mi = -1;
  float2 o0 = make_float2(0.0f, 0.0f);
  float w0 = 0.0f, a0 = 0.0f;
  if (tid < m) {
    const long long i = s * m + tid;
    mi = match_idx[i];
    o0 = obs[i];
    w0 = weights[i];
    a0 = alive(tid);
  }
  // the poses: the oldest dropped, PnP's appended
  for (int i = tid; i < 7 * f; i += THREADS) {
    const bool is_t = i < 3 * f;
    const int c = is_t ? i : i - 3 * f, w = is_t ? 3 : 4, r = c / w;
    const float* src = is_t ? poses_t + s * 3 * f : poses_q + s * 4 * f;
    const float* now = is_t ? t + 3 * s : q + 4 * s;
    float* dst = is_t ? poses_t_out + s * 3 * f : poses_q_out + s * 4 * f;
    dst[c] = r < f - 1 ? src[c + w] : now[c - r * w];
  }
  if (tid == 0) {
    const int n1 = min(n_in[s] + 1, f);
    n_out[s] = n1;
    do_ba[s] = n1 >= f && frame[s] % every == 0;
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
    if (tid + u * THREADS < k) rkp_s[tid + u * THREADS] = kq[u];
  __syncthreads();   // 1: the keys clear, the right keypoints staged
  TRACK_CLOCK(61);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int qi = tid + u * THREADS;
    if (qi < k) {
      const int key = resolve_key(mq[u].d1, qi, k);
      const int target = static_cast<int>(mq[u].idx);
      if (target >= 0) atomicMin(&keys[target], key);
      q_idx[qi] = target;
      q_key[qi] = key;
    }
  }
  __syncthreads();   // 2: the row match resolved
  TRACK_CLOCK(62);
  const long long last = wb + static_cast<long long>(f - 1) * m;
  for (int j = tid; j < m; j += THREADS) {
    if (j >= THREADS) {
      const long long i = s * m + j;
      mi = match_idx[i];
      o0 = obs[i];
      w0 = weights[i];
      a0 = alive(j);
    }
    float2 o_r = make_float2(0.0f, 0.0f);
    float w_r = 0.0f;
    if (k > 0) {
      const int qq = mi < 0 ? 0 : static_cast<int>(mi > k - 1 ? k - 1 : mi);
      const int target = q_idx[qq];
      const int r = target >= 0 && keys[target] == q_key[qq] ? target : -1;
      o_r = rkp_s[r < 0 ? 0 : r];
      w_r = mi >= 0 && r >= 0 ? 1.0f : 0.0f;
    }
    obs_out[last + j] = o0;
    w_out[last + j] = __fmul_rn(w0, a0);
    obs_r_out[last + j] = o_r;
    w_r_out[last + j] = __fmul_rn(w_r, a0);
  }
  TRACK_CLOCK(69);
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

// A cluster kernel's launch configuration: grid (c, S), clusters of c
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;

  ClusterLaunch(int c, int n_streams, size_t smem, void* stream) : cfg{} {
    cfg.gridDim = dim3(c, n_streams);
    cfg.blockDim = dim3(CLUSTER_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = c;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// One launch of a cluster kernel with c blocks a stream (1 to CLUSTER_MAX)
// and `smem` bytes of dynamic shared memory a block
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int c, int n_streams,
                           size_t smem, void* stream, Args&&... args) {
  if (c < 1 || c > CLUSTER_MAX || smem > SMEM_MAX)
    return cudaErrorInvalidValue;
  const cudaError_t err = smem_limit(kernel, smem);
  if (err != cudaSuccess || n_streams < 1) return err;
  ClusterLaunch l(c, n_streams, smem, stream);
  return cudaLaunchKernelEx(&l.cfg, kernel, std::forward<Args>(args)...);
}

// How many clusters of c blocks of a cluster kernel the card runs at once
// (cudaOccupancyMaxActiveClusters), 0 where a block cannot hold `smem`
template <typename... Params>
int max_clusters(void (*kernel)(Params...), int c, size_t smem) {
  if (c < 1 || c > CLUSTER_MAX || smem > SMEM_MAX ||
      smem_limit(kernel, smem) != cudaSuccess) {
    cudaGetLastError();   // leaves no error for the next launch to report
    return 0;
  }
  ClusterLaunch l(c, 1, smem, nullptr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<void*>(kernel),
                                     &l.cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
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
  if (k > 2 * THREADS) return static_cast<int>(cudaErrorInvalidValue);
  if (n_streams > 0) {
    const size_t smem = (k + 3) / 4 * 4;   // the un-marks, cleared by words
    upkeep_pre_kernel<<<n_streams, THREADS, smem,
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
// leaves) and its slots taken [S, M]. A cluster of `cluster` blocks a
// stream (1 to 8).
extern "C" int lvt_staged_promote(
    const float* d1, const float* d2, const long long* best,
    const long long* n_cand, const float* spos, const int* sdesc,
    const int* sctr, const int* sage, const void* svalid, const void* fm,
    const long long* map_size, const float* mpos, const int* mdesc,
    const int* mctr, const int* mage, const void* mvalid, int n_streams,
    int n, int m, int k, float ratio, float abs_th, int staged_threshold,
    int soft_cap, int cluster, int* sctr_out, void* svalid_out,
    void* fm_out, float* mpos_out, int* mdesc_out, int* mctr_out,
    int* mage_out, void* mvalid_out, void* taken, void* stream) {
  const cudaError_t err = launch_cluster(
      staged_promote_kernel, cluster, n_streams,
      staged_smem(n, m, k, cluster), stream, Top2{d1, d2, best, n_cand},
      Store{spos, sdesc, sctr, sage, static_cast<const uint8_t*>(svalid)},
      static_cast<const uint8_t*>(fm), map_size,
      Store{mpos, mdesc, mctr, mage, static_cast<const uint8_t*>(mvalid)},
      n, m, k, ratio, abs_th, staged_threshold, soft_cap, sctr_out,
      static_cast<uint8_t*>(svalid_out), static_cast<uint8_t*>(fm_out),
      StoreOut{mpos_out, mdesc_out, mctr_out, mage_out,
               static_cast<uint8_t*>(mvalid_out)},
      static_cast<uint8_t*>(taken));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// K4: the row site's top-2 ([S, K]; unread with rgbd), the left keypoints
// [S, K, 2], the right ones [S, K, 2] (stereo), the depth [S, K] (rgbd),
// the left validity [S, K] (rgbd) and descriptors [S, K, 8], the pose (t,
// q), the map and the staged set, last_matches [S, 3], the match count [S]
// int64, is_init [S]; fl [14] on the host: the camera (10), the row ratio
// and absolute thresholds, the baseline, reprojection_th2 -> the map' (5
// leaves), its slots taken [S, M], the staged set' (5 leaves), the points
// inserted [S] int64, the map size [S] int64, the window [S, 3], the world
// points [S, K, 3], the candidates [S, K]. A cluster of `cluster` blocks a
// stream (1 to 8).
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
    float window_init, int cluster, float* mpos_out, int* mdesc_out,
    int* mctr_out, int* mage_out, void* mvalid_out, void* map_taken,
    float* spos_out, int* sdesc_out, int* sctr_out, int* sage_out,
    void* svalid_out, long long* n_inserted, long long* map_size,
    float* window, float* pts, void* cand, void* stream) {
  const TriParams prm{view_of(fl), fl[10], fl[11], fl[12], fl[13], policy,
                      staged_threshold, soft_cap, window_init};
  const cudaError_t err = launch_cluster(
      triangulate_insert_kernel, cluster, n_streams,
      tri_smem(k, m, n, rgbd, cluster), stream, Top2{d1, d2, best, n_cand},
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
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The cluster kernels' shape: out[0] the most blocks a stream's cluster
// takes, out[1] threads per block
extern "C" int lvt_track_shape(int* out) {
  out[0] = CLUSTER_MAX;
  out[1] = CLUSTER_THREADS;
  return 0;
}

// How many clusters of `cluster` blocks the card runs at once of op 0
// (staged_promote: N staged points, M map slots, K features) or op 1
// (triangulate_insert: K features, M and N slots, rgbd) at its shared
// memory for this shape (cudaOccupancyMaxActiveClusters); 0 where a block
// cannot hold it
extern "C" int lvt_track_max_clusters(int op, int cluster, int k, int m,
                                      int n, int rgbd) {
  if (cluster < 1 || cluster > CLUSTER_MAX) return 0;
  return op == 0 ? max_clusters(staged_promote_kernel, cluster,
                                staged_smem(n, m, k, cluster))
                 : max_clusters(triangulate_insert_kernel, cluster,
                                tri_smem(k, m, n, rgbd, cluster));
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
  if (k > 2 * THREADS) return static_cast<int>(cudaErrorInvalidValue);
  if (n_streams > 0) {
    // the keys, the keypoints and the validity: under 48 KB
    const size_t smem = sizeof(int) * 2 * (k + 1) + sizeof(float2) * k + k;
    map_accept_kernel<<<n_streams, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        fout, iout, static_cast<const uint8_t*>(visible),
        static_cast<const uint8_t*>(fvalid), kp, m, k, ratio, abs_th,
        retry_min, match_idx, d1, d2, static_cast<uint8_t*>(fm), count,
        static_cast<uint8_t*>(wide), reinterpret_cast<float2*>(obs), weights);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6: T's dual row outputs (fout [S, 2, 2, K] f32, iout [S, 2, 2, K]
// int64; K = 0 without a right camera), match_idx [S, M] int64, obs [S, M,
// 2], weights [S, M], the right keypoints [S, K, 2], PnP's pose (t [S, 3],
// q [S, 4]), the window (poses_t [S, F, 3], poses_q [S, F, 4], obs [S, F,
// M, 2], w [S, F, M], obs_r, w_r, n [S] int32), the map's validity after
// the insertions, the bookkeeping and the cull, the slots taken by the
// insertions and the promotions (null: none) [S, M], the frame number [S]
// -> the window' (seven leaves) and do_ba [S]. Grid (1 + copy blocks, S).
extern "C" int lvt_ba_observe(
    const float* fout, const long long* iout, const long long* match_idx,
    const float* obs, const float* weights, const float* rkp, const float* t,
    const float* q, const float* poses_t, const float* poses_q,
    const float* w_obs, const float* w_w, const float* w_obs_r,
    const float* w_w_r, const int* n, const void* mvalid, const void* bvalid,
    const void* cvalid, const void* taken, const void* ptaken,
    const int* frame, int n_streams, int k, int m, int f, float ratio,
    float abs_th, int every, float* poses_t_out, float* poses_q_out,
    float* obs_out, float* w_out, float* obs_r_out, float* w_r_out,
    int* n_out, void* do_ba, void* stream) {
  if (k > 2 * THREADS || f < 1 || every < 1 || n_streams > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_streams > 0) {
    const long long items = static_cast<long long>(f - 1) * m;
    const int copy = static_cast<int>(
        items > 0 ? (items + THREADS - 1) / THREADS : 0);
    const int copy_blocks = copy < 64 ? copy : 64;
    // the right keypoints, the keys, the queries' targets and keys: under
    // 48 KB
    const size_t smem = sizeof(float2) * k + sizeof(int) * (3 * k + 1);
    ba_observe_kernel<<<dim3(1 + copy_blocks, n_streams), THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        fout, iout, match_idx, reinterpret_cast<const float2*>(obs),
        weights, reinterpret_cast<const float2*>(rkp), t, q, poses_t,
        poses_q, reinterpret_cast<const float2*>(w_obs), w_w,
        reinterpret_cast<const float2*>(w_obs_r), w_w_r, n,
        static_cast<const uint8_t*>(mvalid),
        static_cast<const uint8_t*>(bvalid),
        static_cast<const uint8_t*>(cvalid),
        static_cast<const uint8_t*>(taken),
        static_cast<const uint8_t*>(ptaken), frame, k, m, f, ratio, abs_th,
        every, poses_t_out, poses_q_out, reinterpret_cast<float2*>(obs_out),
        w_out, reinterpret_cast<float2*>(obs_r_out), w_r_out, n_out,
        static_cast<uint8_t*>(do_ba));
  }
  return static_cast<int>(cudaGetLastError());
}
