// The step's tail (lvt_tpu_torch/core/tail.py), two kernels; neither
// replaces a TPU kernel (lvt_tpu runs this work as XLA ops that XLA fuses
// under jit, lvt_tpu/core/step.py:531-570 and :597-612):
//
// * step_tail_kernel: per stream, every leaf of the new state as
//   `lost ? state : (tracking ? new : fallback)` (the BA window's on
//   tracking and not init, the motion state's on not lost), the returned
//   pose, and the frame's metrics with their five means over the map;
//   grid (FIRST_COPY + copy blocks, S);
// * copy_leaves_kernel: the runner's copy of a new state into its static
//   buffers (core/graphs.py), every leaf in one launch.
//
// What bounds them: a frame's bytes (~0.4 MB on path 1) take the card
// ~0.1 us; their time is a launch and one round trip of loads. So every
// load a thread makes is issued before its first use and before the one
// barrier chain (the sums'); the leaves are cut into units of 16 bytes
// (4 or 1 where a leaf is not aligned so), one unit a thread, spread over
// as many blocks as the units need, and a unit's candidate sources (new,
// fallback, state) are all loaded while the stream's flags are, so the
// select waits for one round trip, not two.
//
// The five means are `ordered_sum(where(matched, v, 0)) / max(count, 1)`
// (core/tail.py): the sum pads M to a power of two P with 0.0 and adds
// x[i] + x[i + h] for h = P/2 ... 1, one float32 rounding each. Block q of
// the first five owns mean q: thread t holds x[t + j THREADS] (j < R =
// P / THREADS) and takes the levels h >= THREADS in registers (pairs j and
// j + R/2, ...), shared memory the levels down to 32, and warp 0's
// __shfl_down_sync by 16 ... 1 the rest (lane i + lane i + h): the same
// tree, so the kernel gives the plain version's bits. The counts are
// integers (exact in any order). Nothing is allocated here: every output
// comes from the wrapper.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// map slots a thread of a mean's block holds: M <= THREADS * MAX_R, the
// largest map a shipped config has (TUM's 8192 points)
constexpr int MAX_R = 32;
// blocks of a stream: the five means, the counts and scalars, then the
// copies of the leaves
constexpr int MEANS = 5;
constexpr int SCALARS = MEANS;
constexpr int FIRST_COPY = MEANS + 1;
constexpr int MAX_COPY_BLOCKS = 512;   // per stream; more units loop
constexpr int MAX_LEAVES = 48;         // per launch
// core/state.py's status values
constexpr int NOT_INITIALIZED = 1;
constexpr int TRACKING = 2;
constexpr int LOST = 3;

// a leaf's rule (core/tail.py KINDS)
enum Kind : int { TRACK = 0, TRACK_NOT_INIT = 1, ALWAYS = 2, COPY = 3 };

// One leaf [S, bytes]: its sources (new, fallback, state; COPY reads the
// first), its output, its bytes a stream, its unit, and its first unit
// among a stream's units (the leaves' units in order)
struct Leaf {
  const uint8_t* src[3];
  uint8_t* dst;
  long long bytes;
  int unit;
  int first;
  int kind;
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int n;       // leaves
  int units;   // a stream's units
};

// The tail's other inputs and outputs, [S] each but where said
struct TailArgs {
  const int* status;            // the state's
  const int* frame;             // the state's frame_number
  const long long* matches;     // the map match's count
  const uint8_t* map_valid;     // the state's [S, M]
  const uint8_t* staged_valid;  // the state's [S, N]
  const int* age;               // the bookkept map's [S, M]
  const long long* match_idx;   // [S, M]
  const float* d1;              // [S, M]
  const float* d2;              // [S, M]
  const float* obs;             // [S, M, 2]
  const uint8_t* feat_valid;    // [S, K]
  const long long* map_size;    // the new map's
  const long long* inliers;
  const long long* inserted;
  const uint8_t* wide;
  const uint8_t* ba_ran;        // null: no local BA
  int m, n, k, min_matches;
  int p;                        // M padded to a power of two
  int* frame_out;
  int* status_out;
  // StepMetrics' ints: map_points_count, staged_points_count,
  // image_keypoints, tracked_map_points, inlier_count, triangulated_points,
  // status
  int* ints[7];
  float* means[MEANS];          // mean_age, d1, d2, feature x, y
  uint8_t* wide_out;
  uint8_t* ba_out;
};

// A load issued where it stands (csrc/track.cu's load_now): a coherent
// load whose value passes an empty volatile asm, so it is neither sunk to
// its use nor issued again there
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

struct Flags {
  bool lost, init, tracking;
};

__device__ __forceinline__ Flags flags_of(int status, long long matches,
                                          int min_matches) {
  const bool init = status == NOT_INITIALIZED;
  return Flags{status == LOST, init, matches >= min_matches || init};
}

// One unit of a leaf: every candidate source loaded, then the select
template <typename U>
__device__ __forceinline__ void move(const Leaf& l, long long off,
                                     const Flags& f) {
  const U a = *reinterpret_cast<const U*>(l.src[0] + off);
  U* const out = reinterpret_cast<U*>(l.dst + off);
  if (l.kind == COPY) {
    *out = a;
    return;
  }
  const U b = *reinterpret_cast<const U*>(l.src[1] + off);
  const U c = *reinterpret_cast<const U*>(l.src[2] + off);
  const bool take_new = l.kind == ALWAYS ||
                        (f.tracking && (l.kind == TRACK || !f.init));
  *out = f.lost ? c : (take_new ? a : b);
}

// Units u, u + stride, ... of stream s's leaves
__device__ __forceinline__ void copy_units(const Table& tab, long long s,
                                           int u, int stride,
                                           const Flags& f) {
  for (; u < tab.units; u += stride) {
    int i = 0;
    while (i + 1 < tab.n && tab.leaf[i + 1].first <= u) ++i;
    const Leaf& l = tab.leaf[i];
    const long long off =
        s * l.bytes + static_cast<long long>(u - l.first) * l.unit;
    if (l.unit == 16)
      move<uint4>(l, off, f);
    else if (l.unit == 4)
      move<uint32_t>(l, off, f);
    else
      move<uint8_t>(l, off, f);
  }
}

// Mean q of stream s (module comment): R = P / THREADS map slots a thread
template <int R>
__device__ __forceinline__ void mean_block(const TailArgs& a, long long s,
                                           int q) {
  __shared__ float red[THREADS];
  const int t = threadIdx.x;
  const int status = load_now(a.status + s);
  const long long matches = load_now(a.matches + s);
  long long idx[R];
  float v[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int i = t + j * THREADS;
    idx[j] = -1;
    v[j] = 0.0f;
    if (i < a.m) {
      const long long e = s * a.m + i;
      idx[j] = load_now(a.match_idx + e);
      v[j] = q == 0   ? static_cast<float>(load_now(a.age + e))
             : q == 1 ? load_now(a.d1 + e)
             : q == 2 ? load_now(a.d2 + e)
                      : load_now(a.obs + 2 * e + (q - 3));
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) v[j] = idx[j] >= 0 ? v[j] : 0.0f;
  // the levels h = P/2 ... THREADS in registers
#pragma unroll
  for (int w = R / 2; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) v[j] = __fadd_rn(v[j], v[j + w]);
  // then shared memory down to 32 values, then warp 0
  const int live = a.p < THREADS ? a.p : THREADS;
  red[t] = v[0];
  __syncthreads();
  for (int h = live / 2; h >= 32; h /= 2) {
    if (t < h) red[t] = __fadd_rn(red[t], red[t + h]);
    __syncthreads();
  }
  if (t >= 32) return;
  float x = red[t];
  for (int h = (live < 32 ? live : 32) / 2; h >= 1; h /= 2)
    x = __fadd_rn(x, __shfl_down_sync(FULL, x, h));
  if (t == 0) {
    const long long c = matches < 1 ? 1 : matches;
    a.means[q][s] = status == LOST
                        ? 0.0f
                        : __fdiv_rn(x, __ll2float_rn(c));
  }
}

// The counts over the state's map and staged set and the features, the
// frame counter, the status and the integer metrics of stream s
__device__ __forceinline__ void scalar_block(const TailArgs& a, long long s) {
  __shared__ int part[WARPS][3];
  const int t = threadIdx.x;
  const int status = load_now(a.status + s);
  const int frame = load_now(a.frame + s);
  const long long matches = load_now(a.matches + s);
  const long long map_size = load_now(a.map_size + s);
  const long long inliers = load_now(a.inliers + s);
  const long long inserted = load_now(a.inserted + s);
  const int wide = load_now(a.wide + s);
  const int ba = a.ba_ran != nullptr ? load_now(a.ba_ran + s) : 0;
  int cm = 0, cn = 0, ck = 0;
  for (int i = t; i < a.m; i += THREADS) cm += a.map_valid[s * a.m + i] != 0;
  for (int i = t; i < a.n; i += THREADS)
    cn += a.staged_valid[s * a.n + i] != 0;
  for (int i = t; i < a.k; i += THREADS) ck += a.feat_valid[s * a.k + i] != 0;
  cm = __reduce_add_sync(FULL, cm);
  cn = __reduce_add_sync(FULL, cn);
  ck = __reduce_add_sync(FULL, ck);
  if ((t & 31) == 0) {
    part[t >> 5][0] = cm;
    part[t >> 5][1] = cn;
    part[t >> 5][2] = ck;
  }
  __syncthreads();
  if (t != 0) return;
  cm = cn = ck = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    cm += part[w][0];
    cn += part[w][1];
    ck += part[w][2];
  }
  const Flags f = flags_of(status, matches, a.min_matches);
  const bool live = !f.lost;
  const int st = live && f.tracking ? TRACKING : LOST;
  a.frame_out[s] = frame + 1;
  a.status_out[s] = st;
  a.ints[0][s] = f.init ? static_cast<int>(map_size) : cm;
  a.ints[1][s] = live ? cn : 0;
  a.ints[2][s] = live ? ck : 0;
  a.ints[3][s] = live ? static_cast<int>(matches) : 0;
  a.ints[4][s] = live ? static_cast<int>(inliers) : 0;
  a.ints[5][s] = live && f.tracking ? static_cast<int>(inserted) : 0;
  a.ints[6][s] = st;
  a.wide_out[s] = live && wide != 0 && !f.init;
  a.ba_out[s] = live && ba != 0 && f.tracking && !f.init;
}

template <int R>
__global__ void __launch_bounds__(THREADS) step_tail_kernel(
    const __grid_constant__ Table tab, const __grid_constant__ TailArgs a) {
  const long long s = blockIdx.y;
  const int b = blockIdx.x;
  if (b < MEANS) {
    mean_block<R>(a, s, b);
  } else if (b == SCALARS) {
    scalar_block(a, s);
  } else {
    const Flags f = flags_of(load_now(a.status + s), load_now(a.matches + s),
                             a.min_matches);
    copy_units(tab, s, (b - FIRST_COPY) * THREADS + threadIdx.x,
               (gridDim.x - FIRST_COPY) * THREADS, f);
  }
}

__global__ void __launch_bounds__(THREADS) copy_leaves_kernel(
    const __grid_constant__ Table tab) {
  copy_units(tab, 0, blockIdx.x * THREADS + threadIdx.x,
             gridDim.x * THREADS, Flags{false, false, true});
}

// The table of n leaves: pointers (src0, src1, src2, dst per leaf), bytes
// a stream and kinds; each leaf's unit is the widest of 16, 4, 1 that
// divides its bytes and its four addresses
Table make_table(const void* const* ptrs, const long long* bytes,
                 const int* kinds, int n) {
  Table tab{};
  tab.n = n;
  long long units = 0;
  for (int i = 0; i < n; ++i) {
    Leaf& l = tab.leaf[i];
    uintptr_t bits = static_cast<uintptr_t>(bytes[i]);
    for (int j = 0; j < 3; ++j) {
      l.src[j] = static_cast<const uint8_t*>(ptrs[4 * i + j]);
      bits |= reinterpret_cast<uintptr_t>(ptrs[4 * i + j]);
    }
    l.dst = static_cast<uint8_t*>(const_cast<void*>(ptrs[4 * i + 3]));
    bits |= reinterpret_cast<uintptr_t>(ptrs[4 * i + 3]);
    l.bytes = bytes[i];
    l.unit = bits % 16 == 0 ? 16 : bits % 4 == 0 ? 4 : 1;
    l.first = static_cast<int>(units);
    l.kind = kinds[i];
    units += bytes[i] / l.unit;
  }
  tab.units = static_cast<int>(units);
  return tab;
}

int copy_blocks(int units) {
  const int b = (units + THREADS - 1) / THREADS;
  return b < MAX_COPY_BLOCKS ? b : MAX_COPY_BLOCKS;
}

template <int R>
cudaError_t launch_tail(const Table& tab, const TailArgs& a, int s,
                        cudaStream_t stream) {
  const dim3 grid(FIRST_COPY + copy_blocks(tab.units), s);
  step_tail_kernel<R><<<grid, THREADS, 0, stream>>>(tab, a);
  return cudaGetLastError();
}

}  // namespace

// The step's tail for S streams: n_leaves leaves (at most MAX_LEAVES) as
// (new, fallback, state, out) pointers, bytes a stream and kinds; `in`:
// status, frame_number, matches, the state's map and staged validity, the
// bookkept map's age, match_idx, d1, d2, obs, the features' validity, the
// new map's size, inliers, points inserted, the wide radius used, local
// BA's run (null: no BA); `out`: frame_number', status', then StepMetrics'
// 14 leaves in their order. M up to THREADS * MAX_R.
extern "C" int lvt_step_tail(const void* const* leaf_ptrs,
                             const long long* leaf_bytes,
                             const int* leaf_kinds, int n_leaves,
                             const void* const* in, void* const* out,
                             int n_streams, int m, int n, int k,
                             int min_matches, void* stream) {
  if (n_leaves > MAX_LEAVES) return static_cast<int>(cudaErrorInvalidValue);
  int p = 1;
  while (p < m) p *= 2;
  const int r = p > THREADS ? p / THREADS : 1;
  if (r > MAX_R) return static_cast<int>(cudaErrorInvalidValue);
  if (n_streams <= 0) return static_cast<int>(cudaGetLastError());
  const Table tab = make_table(leaf_ptrs, leaf_bytes, leaf_kinds, n_leaves);
  TailArgs a{};
  a.status = static_cast<const int*>(in[0]);
  a.frame = static_cast<const int*>(in[1]);
  a.matches = static_cast<const long long*>(in[2]);
  a.map_valid = static_cast<const uint8_t*>(in[3]);
  a.staged_valid = static_cast<const uint8_t*>(in[4]);
  a.age = static_cast<const int*>(in[5]);
  a.match_idx = static_cast<const long long*>(in[6]);
  a.d1 = static_cast<const float*>(in[7]);
  a.d2 = static_cast<const float*>(in[8]);
  a.obs = static_cast<const float*>(in[9]);
  a.feat_valid = static_cast<const uint8_t*>(in[10]);
  a.map_size = static_cast<const long long*>(in[11]);
  a.inliers = static_cast<const long long*>(in[12]);
  a.inserted = static_cast<const long long*>(in[13]);
  a.wide = static_cast<const uint8_t*>(in[14]);
  a.ba_ran = static_cast<const uint8_t*>(in[15]);
  a.m = m;
  a.n = n;
  a.k = k;
  a.min_matches = min_matches;
  a.p = p;
  a.frame_out = static_cast<int*>(out[0]);
  a.status_out = static_cast<int*>(out[1]);
  // StepMetrics' order: 4 ints, 5 means, 2 ints, the wide radius, the
  // status, local BA
  for (int i = 0; i < 4; ++i) a.ints[i] = static_cast<int*>(out[2 + i]);
  for (int i = 0; i < MEANS; ++i) a.means[i] = static_cast<float*>(out[6 + i]);
  a.ints[4] = static_cast<int*>(out[11]);
  a.ints[5] = static_cast<int*>(out[12]);
  a.wide_out = static_cast<uint8_t*>(out[13]);
  a.ints[6] = static_cast<int*>(out[14]);
  a.ba_out = static_cast<uint8_t*>(out[15]);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 1: return static_cast<int>(launch_tail<1>(tab, a, n_streams, st));
    case 2: return static_cast<int>(launch_tail<2>(tab, a, n_streams, st));
    case 4: return static_cast<int>(launch_tail<4>(tab, a, n_streams, st));
    case 8: return static_cast<int>(launch_tail<8>(tab, a, n_streams, st));
    case 16: return static_cast<int>(launch_tail<16>(tab, a, n_streams, st));
    default: return static_cast<int>(launch_tail<32>(tab, a, n_streams, st));
  }
}

// n_leaves leaves (at most MAX_LEAVES) copied whole: (src, dst) pointers
// and bytes
extern "C" int lvt_copy_leaves(const void* const* ptrs,
                               const long long* bytes, int n_leaves,
                               void* stream) {
  if (n_leaves > MAX_LEAVES) return static_cast<int>(cudaErrorInvalidValue);
  const void* quad[4 * MAX_LEAVES];
  int kinds[MAX_LEAVES];
  for (int i = 0; i < n_leaves; ++i) {
    quad[4 * i] = quad[4 * i + 1] = quad[4 * i + 2] = ptrs[2 * i];
    quad[4 * i + 3] = ptrs[2 * i + 1];
    kinds[i] = COPY;
  }
  const Table tab = make_table(quad, bytes, kinds, n_leaves);
  if (tab.units > 0)
    copy_leaves_kernel<<<copy_blocks(tab.units), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(tab);
  return static_cast<int>(cudaGetLastError());
}

// The kernels' limits: out[0] leaves a launch, out[1] step_tail's largest
// M
extern "C" int lvt_tail_shape(int* out) {
  out[0] = MAX_LEAVES;
  out[1] = THREADS * MAX_R;
  return 0;
}
