// The end of a frame (lvt_tpu_torch/core/tail.py, core/graphs.py), two
// kernels; neither replaces a TPU kernel (lvt_tpu runs the tail as XLA ops
// that XLA fuses under jit, lvt_tpu/core/step.py:531-570 and :597-612, and
// carries the state from frame to frame in lax.scan, :665):
//
// * step_tail_kernel: per stream, every leaf of the new state as
//   `lost ? state : (tracking ? new : fallback)` (the BA window's on
//   tracking and not init, the motion state's on not lost), the returned
//   pose, and the frame's metrics with their five means over the map. As
//   the op (no chunk) it writes fresh outputs. Inside a runner (a chunk's
//   table, core/graphs.py::Epilogue) it ends the frame on the device: the
//   new state goes into the runner's buffers (what it reads), a stream
//   LOST after the frame takes the runner's fresh state but its pose
//   (MultiStreamVO's auto-reset), the pose and the metrics go into row i
//   of the chunk's outputs, frame i + 1's inputs into the runner's input
//   buffers, i counted on the device (tickets in the table): a graphed
//   frame is one replay with no copy launched from the host;
// * copy_leaves_kernel: the runner's copies that remain: a chunk's table
//   and frame 0's inputs (one launch a chunk), the end of a frame whose
//   tail ran as torch ops (a group's collectives) as copies by the same
//   tickets, and a state copied whole.
//
// Grid of step_tail_kernel: (C, S + X), a thread-block cluster of C = 8
// blocks a stream, then X clusters that copy the next frame's inputs. What
// bounds it: a frame's bytes (path 1: the state's 0.1 MB and the next
// KITTI pair's 0.93 MB, read and written) take the card ~0.6 us; its time
// is the launch, two round trips of loads and one cluster barrier. The new
// state overwrites what the kernel reads (the flags come from the state's
// status; the counts from its map's and staged set's validity), so a
// stream's cluster runs in two phases: phase 1 issues every load that a
// store could clobber (status, frame, the validity counted), looks up the
// leaves of B units a thread (16, 8, 4 or 1 bytes each) in the table, and
// once the status is in loads each unit from the one source its stream's
// flags pick, then the means' inputs; the block sums the means and counts
// and pushes them into rank 0's shared memory; one cluster barrier
// (arrive.release, wait.acquire); phase 2 stores the units, and rank 0
// writes the means, the counts and the scalars.
// B (4 or 8) holds a stream's state where 8 units a thread do, so every
// load comes before the barrier and any source may alias any buffer. A
// state of more than C x THREADS x 8 units (M above ~2500 with a staged
// set of M) streams the rest after the barrier, each unit read and
// written by one thread: a source that is the buffer it goes to is read
// before it is written, and the wrapper refuses a source that overlaps
// another buffer there. Each block takes a ticket from the table (one
// atomicAdd, with its first loads); a chunk's launches have one grid, and
// run in stream order, so the tickets of frame i are i G ...
// i G + G - 1 (G blocks a launch) and every block of a launch reads the
// same frame index i = ticket / G, with no fence and no last block.
// TAIL_CLOCK(slot) marks the phases for scripts/torch_tail_clocks.py.
//
// The five means are `ordered_sum(where(matched, v, 0)) / max(count, 1)`
// (core/tail.py): padded to a power of two P with 0.0, x[i] + x[i + h] for
// h = P/2 ... 1, one float32 rounding each. That tree splits by residues:
// for any power of two G <= P, ordered_sum(x) is ordered_sum over g < G
// of ordered_sum(x[g::G]). So block b (of G_e = min(C, P)) owns x[b::G_e],
// its thread t (of T_e = min(THREADS, P / G_e)) owns x[b + G_e t::G_e T_e],
// Q = P / (G_e T_e) slots; a thread sums its slots in registers (Q <= 8),
// or, past 8, streams them in batches of 8 in bit-reversed order with a
// stack of partial sums (no bound on M); the block adds its threads in
// shared memory down to 32 and warp 0's __shfl_down_sync (lane i + lane
// i + h), and rank 0 adds the G_e blocks' sums by the same tree: the bits
// of the plain version at any M and any C. The counts are integers (exact
// in any order). Nothing is allocated here: every output comes from the
// wrapper.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

#ifndef TAIL_CLOCK
#define TAIL_CLOCK(slot)
#endif

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CLUSTER = 8;          // blocks a stream (portable cluster size)
constexpr int MEANS = 5;
constexpr int COUNTS = 3;
constexpr int QMAX = 8;             // a thread's slots of a mean at once
constexpr int STACK = 32;           // levels of a thread's streamed sum
constexpr int BATCH = 4;            // units a thread streams at once
constexpr int MAX_B = 8;            // units a thread holds over the barrier
constexpr int MAX_LEAVES = 48;      // per launch
constexpr int ROWS = 16;            // the pose (t, q), StepMetrics' 14
constexpr int MAX_INPUTS = 8;       // a frame's inputs
constexpr int MAX_COPY_CLUSTERS = 128;
constexpr int MAX_COPY_BLOCKS = 1024;
// core/state.py's status values
constexpr int NOT_INITIALIZED = 1;
constexpr int TRACKING = 2;
constexpr int LOST = 3;

// a leaf's rule (core/tail.py KINDS); COPY: its first source
enum Kind : int { TRACK = 0, TRACK_NOT_INIT = 1, ALWAYS = 2, COPY = 3 };
// a leaf's sources: the tracked value, the fallback, the state, and the
// runner's fresh state (one stream's, no stream axis; null: no reset)
enum Source : int { NEW = 0, FALLBACK = 1, STATE = 2, FRESH = 3 };
// copy_leaves_kernel's modes
enum Mode : int { PLAIN = 0, START = 1, FRAME = 2 };

// One leaf [S, bytes]: its sources, its buffer (null: the row only), its
// row (a pose leaf, or a row copied by copy_leaves; -1: none; a pose leaf
// keeps its value on a reset), its bytes a stream and its unit
struct Leaf {
  const uint8_t* src[4];
  uint8_t* dst;
  long long bytes;
  int unit;
  int kind;
  int row;
};

// The leaves, and each one's first unit among a stream's units (the
// leaves' units in order) apart, in the table's first lines: a unit's
// search reads those few lines of the constant cache, and its leaf's one
struct Table {
  int first[MAX_LEAVES];
  int n;       // leaves
  int units;   // a stream's units
  Leaf leaf[MAX_LEAVES];
};

// A runner's chunk (core/graphs.py::Epilogue.table): written by a START
// launch of copy_leaves_kernel, read by every frame's launch
struct Chunk {
  unsigned long long frames;      // frames of the chunk ended (for readers
                                  // after the launches)
  unsigned long long ticket;      // blocks of the chunk's launches so far
  int n;                          // frames in the chunk
  uint8_t* row[ROWS];             // the outputs [N, S, ...]
  const uint8_t* in[MAX_INPUTS];  // the chunk's inputs [N, ...]
};

// What a launch knows of its frame, by value: the runner's table (null:
// no chunk, the rows at `row` as frame 0 of 1, or nowhere where null), the
// rows' bytes a stream, the runner's input buffers and a frame's bytes
struct Frame {
  Chunk* chunk;
  uint8_t* row[ROWS];
  long long row_bytes[ROWS];
  uint8_t* in_dst[MAX_INPUTS];
  long long in_bytes[MAX_INPUTS];
  int n_in;
};

// One launch's frame as its blocks read it: the index, the chunk's length,
// the rows and the chunk's inputs
struct At {
  unsigned long long i;
  int n;
  uint8_t* row[ROWS];
  const uint8_t* in[MAX_INPUTS];
};

// The tail's other inputs, [S] each but where said
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
  const int* fresh_frame;       // the fresh state's (null: no reset)
  const int* fresh_status;
  int* frame_out;               // the new state's frame_number, status
  int* status_out;
  int m, n, k, min_matches;
  int ge, te;                   // the means' blocks and threads
  int q_len;                    // a thread's slots of a mean (Q)
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

// A split cluster barrier (csrc/track.cu's): arrive, releasing this
// thread's writes at cluster scope, then wait, acquiring every other's
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct Flags {
  bool lost, init, tracking, reset;
};

// A stream's flags; `reset`: it is LOST after the frame and the runner
// resets such streams
__device__ __forceinline__ Flags flags_of(int status, long long matches,
                                          int min_matches, bool reset_on) {
  const bool init = status == NOT_INITIALIZED;
  const bool lost = status == LOST;
  const bool tracking = matches >= min_matches || init;
  return Flags{lost, init, tracking, reset_on && (lost || !tracking)};
}

// The source a unit of leaf `l` takes on a stream's flags
__device__ __forceinline__ int pick(const Leaf& l, const Flags& f) {
  if (l.kind == COPY) return NEW;
  if (f.reset && l.row < 0) return FRESH;
  if (f.lost) return STATE;
  const bool take_new = l.kind == ALWAYS ||
                        (f.tracking && (l.kind == TRACK || !f.init));
  return take_new ? NEW : FALLBACK;
}

// The last leaf whose first unit is at or before unit u (a leaf of no
// units shares its `first` with the next)
__device__ __forceinline__ int leaf_of(const Table& tab, int u) {
  int lo = 0, hi = tab.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.first[mid] <= u)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// A unit's load, issued where it stands (load_now's empty volatile asm):
// a thread's held units are loaded before the cluster barrier and stored
// after it
__device__ __forceinline__ uint4 load_unit(const uint8_t* p, int unit) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (unit == 16) {
    v = __ldca(reinterpret_cast<const uint4*>(p));
  } else if (unit == 8) {
    const uint2 w = __ldca(reinterpret_cast<const uint2*>(p));
    v.x = w.x;
    v.y = w.y;
  } else if (unit == 4) {
    v.x = __ldca(reinterpret_cast<const unsigned int*>(p));
  } else {
    v.x = __ldca(p);
  }
  asm volatile("" : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w));
  return v;
}

__device__ __forceinline__ void store_unit(uint8_t* p, const uint4& v,
                                           int unit) {
  if (unit == 16)
    *reinterpret_cast<uint4*>(p) = v;
  else if (unit == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(v.x, v.y);
  else if (unit == 4)
    *reinterpret_cast<uint32_t*>(p) = v.x;
  else
    *p = static_cast<uint8_t>(v.x);
}

// Units u0 + j stride (j < NB) of stream s's leaves (S streams), each
// loaded from the source its flags pick; kept with its leaf for the store
// into its buffer and, where `rows` and the leaf has a row, row at.i of it
template <int NB>
struct Batch {
  uint4 v[NB];
  int leaf[NB];   // -1: past the units
};

// The leaves of units u0 + j stride (the table in constant memory; no
// load of the card's memory, so it goes ahead of the flags)
template <int NB>
__device__ __forceinline__ void find_leaves(Batch<NB>& b, const Table& tab,
                                            long long u0, long long stride) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const long long u = u0 + j * stride;
    b.leaf[j] = u < tab.units ? leaf_of(tab, static_cast<int>(u)) : -1;
  }
}

template <int NB>
__device__ __forceinline__ void load_batch(Batch<NB>& b, const Table& tab,
                                           long long s, long long u0,
                                           long long stride, const Flags& f) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (b.leaf[j] < 0) continue;
    const Leaf& l = tab.leaf[b.leaf[j]];
    const long long off = (u0 + j * stride - tab.first[b.leaf[j]]) * l.unit;
    const int src = pick(l, f);
    b.v[j] = load_unit(src == FRESH ? l.src[FRESH] + off
                                    : l.src[src] + s * l.bytes + off,
                       l.unit);
  }
}

template <int NB>
__device__ __forceinline__ void store_batch(const Batch<NB>& b,
                                            const Table& tab, long long s,
                                            int n_streams, long long u0,
                                            long long stride, const At& at,
                                            bool rows, const Frame& fr) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (b.leaf[j] < 0) continue;
    const Leaf& l = tab.leaf[b.leaf[j]];
    const long long off = (u0 + j * stride - tab.first[b.leaf[j]]) * l.unit;
    if (l.dst != nullptr) store_unit(l.dst + s * l.bytes + off, b.v[j], l.unit);
    if (rows && l.row >= 0 && at.row[l.row] != nullptr)
      store_unit(at.row[l.row] +
                     (static_cast<long long>(at.i) * n_streams + s) *
                         fr.row_bytes[l.row] +
                     off,
                 b.v[j], l.unit);
  }
}

// Units u0, u0 + stride, ... of stream s's leaves: BATCH loaded before
// any is stored
__device__ void move_units(const Table& tab, long long s, int n_streams,
                           long long u0, long long stride, const Flags& f,
                           const At& at, bool rows, const Frame& fr) {
  for (; u0 < tab.units; u0 += stride * BATCH) {
    Batch<BATCH> b;
    find_leaves(b, tab, u0, stride);
    load_batch(b, tab, s, u0, stride, f);
    store_batch(b, tab, s, n_streams, u0, stride, at, rows, fr);
  }
}

template <typename U>
__device__ void copy_units(const U* src, U* dst, long long n, long long t,
                           long long stride) {
  for (; t < n; t += stride * BATCH) {
    U v[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      if (t + j * stride < n) v[j] = src[t + j * stride];
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      if (t + j * stride < n) dst[t + j * stride] = v[j];
  }
}

// `bytes` from src to dst by `stride` threads of which this is t, in units
// of the widest of 16, 8, 4 and 1 bytes that divides both addresses and
// the size
__device__ void copy_span(const uint8_t* src, uint8_t* dst, long long bytes,
                          long long t, long long stride) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(dst) |
                         static_cast<uintptr_t>(bytes);
  if (bits % 16 == 0)
    copy_units(reinterpret_cast<const uint4*>(src),
               reinterpret_cast<uint4*>(dst), bytes / 16, t, stride);
  else if (bits % 8 == 0)
    copy_units(reinterpret_cast<const uint2*>(src),
               reinterpret_cast<uint2*>(dst), bytes / 8, t, stride);
  else if (bits % 4 == 0)
    copy_units(reinterpret_cast<const uint32_t*>(src),
               reinterpret_cast<uint32_t*>(dst), bytes / 4, t, stride);
  else
    copy_units(src, dst, bytes, t, stride);
}

// Warp 0 of a block reads its launch's frame: lane j's word (rows 0-15,
// the chunk's inputs 16-23, the block's ticket 24, the chunk's length 25),
// from the chunk's table, or, with no chunk, frame 0 of 1 at the Frame's
// rows; the loads and the ticket's atomicAdd issue here and the words go
// to `at` later (put_at), so no lane waits for them before its other
// loads
__device__ __forceinline__ unsigned long long fetch_at(const Frame& fr,
                                                       int lane) {
  const Chunk* c = fr.chunk;
  if (c == nullptr) {
    if (lane < ROWS) return reinterpret_cast<unsigned long long>(fr.row[lane]);
    return lane == ROWS + MAX_INPUTS + 1 ? 1 : 0;
  }
  if (lane < ROWS)
    return reinterpret_cast<unsigned long long>(
        *reinterpret_cast<uint8_t* const volatile*>(&c->row[lane]));
  if (lane < ROWS + MAX_INPUTS)
    return reinterpret_cast<unsigned long long>(
        *reinterpret_cast<const uint8_t* const volatile*>(
            &c->in[lane - ROWS]));
  if (lane == ROWS + MAX_INPUTS)
    return atomicAdd(&const_cast<Chunk*>(c)->ticket, 1ull);
  if (lane == ROWS + MAX_INPUTS + 1)
    return static_cast<unsigned long long>(
        *reinterpret_cast<const volatile int*>(&c->n));
  return 0;
}

__device__ __forceinline__ void put_at(const Frame& fr, At& at,
                                       unsigned long long w, int lane) {
  if (lane < ROWS) {
    at.row[lane] = reinterpret_cast<uint8_t*>(w);
  } else if (lane < ROWS + MAX_INPUTS) {
    at.in[lane - ROWS] = reinterpret_cast<const uint8_t*>(w);
  } else if (lane == ROWS + MAX_INPUTS) {
    if (fr.chunk == nullptr) {
      at.i = 0;
      return;
    }
    const unsigned long long blocks =
        static_cast<unsigned long long>(gridDim.x) * gridDim.y;
    at.i = w / blocks;
    if (w % blocks == 0) fr.chunk->frames = at.i + 1;
  } else if (lane == ROWS + MAX_INPUTS + 1) {
    at.n = static_cast<int>(w);
  }
}

// Frame at.i + 1's inputs into the runner's buffers, where the chunk has
// it, by `stride` threads of which this is t
__device__ __forceinline__ void copy_next(const Frame& fr, const At& at,
                                          long long t, long long stride) {
  if (fr.chunk == nullptr || at.i + 1 >= static_cast<unsigned long long>(at.n))
    return;
  for (int k = 0; k < fr.n_in; ++k)
    copy_span(at.in[k] + (at.i + 1) * fr.in_bytes[k], fr.in_dst[k],
              fr.in_bytes[k], t, stride);
}

// The five masked values of one mean's batch of QB slots e0 + j step
// (j < QB) of stream s, summed by the tree over j (pairs j, j + QB/2, ...)
template <int QB>
__device__ __forceinline__ void batch_sums(const TailArgs& a, long long s,
                                           long long e0, long long step,
                                           float out[MEANS]) {
  long long idx[QB];
  float v[MEANS][QB];
#pragma unroll
  for (int j = 0; j < QB; ++j) {
    const long long e = e0 + j * step;
    idx[j] = -1;
#pragma unroll
    for (int q = 0; q < MEANS; ++q) v[q][j] = 0.0f;
    if (e < a.m) {
      const long long g = s * a.m + e;
      idx[j] = load_now(a.match_idx + g);
      v[0][j] = static_cast<float>(load_now(a.age + g));
      v[1][j] = load_now(a.d1 + g);
      v[2][j] = load_now(a.d2 + g);
      v[3][j] = load_now(a.obs + 2 * g);
      v[4][j] = load_now(a.obs + 2 * g + 1);
    }
  }
#pragma unroll
  for (int j = 0; j < QB; ++j)
#pragma unroll
    for (int q = 0; q < MEANS; ++q) v[q][j] = idx[j] >= 0 ? v[q][j] : 0.0f;
#pragma unroll
  for (int w = QB / 2; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j)
#pragma unroll
      for (int q = 0; q < MEANS; ++q)
        v[q][j] = __fadd_rn(v[q][j], v[q][j + w]);
#pragma unroll
  for (int q = 0; q < MEANS; ++q) out[q] = v[q][0];
}

// Thread t of block b's sums of its Q = QB * A slots b + ge (t + te q):
// one batch (A = 1), or A batches of the residues r + A j, r in
// bit-reversed order, merged by a stack of partial sums (a binary counter:
// batch p merges with each level whose bit of p is set)
template <int QB>
__device__ void mean_sums(const TailArgs& a, long long s, int b, int t,
                          float out[MEANS]) {
  const long long ge = a.ge, te = a.te;
  const long long batches = a.q_len / QB;
  if (batches == 1) {
    batch_sums<QB>(a, s, b + ge * t, ge * te, out);
    return;
  }
  const int bits = __ffsll(batches) - 1;
  float stack[MEANS][STACK];
  for (long long p = 0; p < batches; ++p) {
    const long long r =
        static_cast<long long>(__brevll(static_cast<unsigned long long>(p)) >>
                               (64 - bits));
    float c[MEANS];
    batch_sums<QB>(a, s, b + ge * (t + te * r), ge * te * batches, c);
    int l = 0;
    for (; (p >> l) & 1; ++l)
#pragma unroll
      for (int q = 0; q < MEANS; ++q) c[q] = __fadd_rn(stack[q][l], c[q]);
#pragma unroll
    for (int q = 0; q < MEANS; ++q) stack[q][l] = c[q];
  }
#pragma unroll
  for (int q = 0; q < MEANS; ++q) out[q] = stack[q][bits];
}

// Copy clusters (blockIdx.y >= S): frame i + 1's inputs
__device__ void copy_block(const Frame& fr, At& at, int n_streams) {
  TAIL_CLOCK(10);
  const int t = threadIdx.x;
  if (t < 32) put_at(fr, at, fetch_at(fr, t), t);
  __syncthreads();
  TAIL_CLOCK(11);
  const long long blocks = static_cast<long long>(gridDim.y - n_streams) *
                           gridDim.x;
  const long long block =
      static_cast<long long>(blockIdx.y - n_streams) * gridDim.x + blockIdx.x;
  copy_next(fr, at, block * THREADS + t, blocks * THREADS);
  TAIL_CLOCK(19);
}

template <int QB, int NB>
__global__ void __launch_bounds__(THREADS) step_tail_kernel(
    const __grid_constant__ Table tab, const __grid_constant__ TailArgs a,
    const __grid_constant__ Frame fr, int n_streams) {
  __shared__ At at;
  if (static_cast<int>(blockIdx.y) >= n_streams) {
    copy_block(fr, at, n_streams);
    return;
  }
  __shared__ float red[MEANS][THREADS];
  __shared__ int wpart[WARPS][COUNTS];
  __shared__ float mean_part[MEANS][CLUSTER];   // rank 0's: the blocks' sums
  __shared__ int count_part[COUNTS][CLUSTER];   // rank 0's: the blocks' counts
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x;
  const long long s = blockIdx.y;
  TAIL_CLOCK(0);

  // ---- phase 1: every load a store of the stream could clobber, and the
  // means' inputs, all issued before the first value is used
  const unsigned long long word = t < 32 ? fetch_at(fr, t) : 0;
  const int status = load_now(a.status + s);
  const long long matches = load_now(a.matches + s);
  int frame = 0, fresh_frame = 0, fresh_status = 0, wide = 0, ba = 0;
  long long map_size = 0, inliers = 0, inserted = 0;
  if (rank == 0 && t == MEANS) {
    frame = load_now(a.frame + s);
    map_size = load_now(a.map_size + s);
    inliers = load_now(a.inliers + s);
    inserted = load_now(a.inserted + s);
    wide = load_now(a.wide + s);
    ba = a.ba_ran != nullptr ? load_now(a.ba_ran + s) : 0;
    if (a.fresh_status != nullptr) {
      fresh_frame = load_now(a.fresh_frame);
      fresh_status = load_now(a.fresh_status);
    }
  }
  // the counts' first bytes (path 1's only ones), then the rest below
  const long long first = static_cast<long long>(rank) * THREADS + t;
  const long long step = static_cast<long long>(c) * THREADS;
  const int v0 = first < a.m ? load_now(a.map_valid + s * a.m + first) : 0;
  const int v1 =
      first < a.n ? load_now(a.staged_valid + s * a.n + first) : 0;
  const int v2 = first < a.k ? load_now(a.feat_valid + s * a.k + first) : 0;
  // this thread's NB units: their leaves (the table in constant memory)
  // while those loads are in flight, then, once the status is in, each
  // from the source its flags pick, ahead of the means' loads; stored
  // after the cluster barrier
  Batch<NB> held;
  find_leaves(held, tab, first, step);
  const Flags f = flags_of(status, matches, a.min_matches,
                           a.fresh_status != nullptr);
  load_batch(held, tab, s, first, step, f);
  const int live = rank < a.ge ? a.te : 0;
  float part[MEANS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (t < live) mean_sums<QB>(a, s, rank, t, part);
  int cnt[COUNTS] = {v0 != 0, v1 != 0, v2 != 0};
  for (long long j = first + step; j < a.m; j += step)
    cnt[0] += a.map_valid[s * a.m + j] != 0;
  for (long long j = first + step; j < a.n; j += step)
    cnt[1] += a.staged_valid[s * a.n + j] != 0;
  for (long long j = first + step; j < a.k; j += step)
    cnt[2] += a.feat_valid[s * a.k + j] != 0;
  TAIL_CLOCK(1);
  if (t < 32) put_at(fr, at, word, t);
  // the block's sums: shared memory down to 32 values, then warp 0; the
  // counts by warp, then thread 0
#pragma unroll
  for (int q = 0; q < MEANS; ++q) red[q][t] = part[q];
#pragma unroll
  for (int j = 0; j < COUNTS; ++j) cnt[j] = __reduce_add_sync(FULL, cnt[j]);
  if ((t & 31) == 0)
#pragma unroll
    for (int j = 0; j < COUNTS; ++j) wpart[t >> 5][j] = cnt[j];
  __syncthreads();
  TAIL_CLOCK(2);
  for (int h = live / 2; h >= 32; h /= 2) {
    if (t < h)
#pragma unroll
      for (int q = 0; q < MEANS; ++q)
        red[q][t] = __fadd_rn(red[q][t], red[q][t + h]);
    __syncthreads();
  }
  if (t < 32) {
    float x[MEANS];
#pragma unroll
    for (int q = 0; q < MEANS; ++q) x[q] = red[q][t];
    for (int h = (live < 32 ? live : 32) / 2; h >= 1; h /= 2)
#pragma unroll
      for (int q = 0; q < MEANS; ++q)
        x[q] = __fadd_rn(x[q], __shfl_down_sync(FULL, x[q], h));
    if (t == 0) {
      if (rank < a.ge) {
        float* mp = cluster.map_shared_rank(&mean_part[0][0], 0);
#pragma unroll
        for (int q = 0; q < MEANS; ++q) mp[q * CLUSTER + rank] = x[q];
      }
      int* cp = cluster.map_shared_rank(&count_part[0][0], 0);
#pragma unroll
      for (int j = 0; j < COUNTS; ++j) {
        int sum = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) sum += wpart[w][j];
        cp[j * CLUSTER + rank] = sum;
      }
    }
  }
  TAIL_CLOCK(3);
  cluster_barrier();
  TAIL_CLOCK(4);

  // ---- phase 2: the stores
  const bool rows = at.i < static_cast<unsigned long long>(at.n);
  store_batch(held, tab, s, n_streams, first, step, at, rows, fr);
  const long long at_row = static_cast<long long>(at.i) * n_streams + s;
  if (rank == 0 && t < MEANS && rows && at.row[2 + 4 + t] != nullptr) {
    // mean t: the blocks' sums by the tree over ranks
    float x[CLUSTER];
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) x[r] = r < a.ge ? mean_part[t][r] : 0.0f;
#pragma unroll
    for (int h = CLUSTER / 2; h >= 1; h /= 2)
#pragma unroll
      for (int r = 0; r < h; ++r)
        if (r + h < a.ge) x[r] = __fadd_rn(x[r], x[r + h]);
    const long long n_matched = matches < 1 ? 1 : matches;
    reinterpret_cast<float*>(at.row[6 + t])[at_row] =
        f.lost ? 0.0f : __fdiv_rn(x[0], __ll2float_rn(n_matched));
  }
  if (rank == 0 && t == MEANS) {
    int cm = 0, cn = 0, ck = 0;
    for (int r = 0; r < c; ++r) {
      cm += count_part[0][r];
      cn += count_part[1][r];
      ck += count_part[2][r];
    }
    const bool on = !f.lost;
    const int st = on && f.tracking ? TRACKING : LOST;
    a.frame_out[s] = f.reset ? fresh_frame : frame + 1;
    a.status_out[s] = f.reset ? fresh_status : st;
    if (rows) {
      const int ints[7] = {f.init ? static_cast<int>(map_size) : cm,
                           on ? cn : 0,
                           on ? ck : 0,
                           on ? static_cast<int>(matches) : 0,
                           on ? static_cast<int>(inliers) : 0,
                           on && f.tracking ? static_cast<int>(inserted) : 0,
                           st};
      // StepMetrics' order: 4 ints, 5 means, 2 ints, the wide radius, the
      // status, local BA (rows 2.. after the pose's two)
      const int int_rows[7] = {2, 3, 4, 5, 11, 12, 14};
#pragma unroll
      for (int j = 0; j < 7; ++j)
        if (at.row[int_rows[j]] != nullptr)
          reinterpret_cast<int*>(at.row[int_rows[j]])[at_row] = ints[j];
      if (at.row[13] != nullptr)
        at.row[13][at_row] = on && wide != 0 && !f.init;
      if (at.row[15] != nullptr)
        at.row[15][at_row] = on && ba != 0 && f.tracking && !f.init;
    }
  }
  TAIL_CLOCK(5);
  move_units(tab, s, n_streams, first + step * NB, step, f, at, rows, fr);
  TAIL_CLOCK(9);
}

// copy_leaves_kernel: PLAIN, every unit of the leaves (COPY); START, the
// chunk's table written (its tickets at 0) and frame 0's inputs copied;
// FRAME, the units (a row leaf into row i of the chunk's outputs, i from
// the block's ticket) and frame i + 1's inputs
__global__ void __launch_bounds__(THREADS) copy_leaves_kernel(
    const __grid_constant__ Table tab, const __grid_constant__ Frame fr,
    const __grid_constant__ Chunk start, int mode) {
  __shared__ At at;
  const int t = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS + t;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  if (mode == START) {
    if (first == 0) *fr.chunk = start;
    for (int k = 0; k < fr.n_in; ++k)
      copy_span(start.in[k], fr.in_dst[k], fr.in_bytes[k], first, stride);
    return;
  }
  bool rows = false;
  if (mode == FRAME) {
    if (t < 32) put_at(fr, at, fetch_at(fr, t), t);
    __syncthreads();
    rows = at.i < static_cast<unsigned long long>(at.n);
  }
  move_units(tab, 0, 1, first, stride, Flags{false, false, true, false}, at,
             rows, fr);
  if (mode == FRAME) copy_next(fr, at, first, stride);
}

// The table of n leaves: pointers (new, fallback, state, fresh, dst per
// leaf), bytes a stream, kinds and rows; each leaf's unit is the widest of
// 16, 8, 4, 1 that divides its bytes and its addresses (rows come from
// torch.empty: 16-byte aligned, and row i at i times the leaf's bytes)
Table make_table(const void* const* ptrs, const long long* bytes,
                 const int* kinds, const int* rows, int n) {
  Table tab{};
  tab.n = n;
  long long units = 0;
  for (int i = 0; i < n; ++i) {
    Leaf& l = tab.leaf[i];
    uintptr_t bits = static_cast<uintptr_t>(bytes[i]);
    for (int j = 0; j < 4; ++j) {
      l.src[j] = static_cast<const uint8_t*>(ptrs[5 * i + j]);
      bits |= reinterpret_cast<uintptr_t>(ptrs[5 * i + j]);
    }
    l.dst = static_cast<uint8_t*>(const_cast<void*>(ptrs[5 * i + 4]));
    bits |= reinterpret_cast<uintptr_t>(ptrs[5 * i + 4]);
    l.bytes = bytes[i];
    l.unit = bits % 16 == 0 ? 16 : bits % 8 == 0 ? 8 : bits % 4 == 0 ? 4 : 1;
    tab.first[i] = static_cast<int>(units);
    l.kind = kinds[i];
    l.row = rows[i];
    units += bytes[i] / l.unit;
  }
  tab.units = static_cast<int>(units);
  return tab;
}

Frame make_frame(void* chunk, void* const* row, const long long* row_bytes,
                 void* const* in_dst, const long long* in_bytes, int n_in) {
  Frame fr{};
  fr.chunk = static_cast<Chunk*>(chunk);
  for (int r = 0; r < ROWS; ++r) {
    fr.row[r] = row != nullptr ? static_cast<uint8_t*>(row[r]) : nullptr;
    fr.row_bytes[r] = row_bytes[r];
  }
  fr.n_in = n_in;
  for (int k = 0; k < n_in; ++k) {
    fr.in_dst[k] = static_cast<uint8_t*>(in_dst[k]);
    fr.in_bytes[k] = in_bytes[k];
  }
  return fr;
}

long long input_bytes(const Frame& fr) {
  long long total = 0;
  for (int k = 0; k < fr.n_in; ++k) total += fr.in_bytes[k];
  return total;
}

// blocks that move `bytes` at BATCH 8-byte units a thread, at least 1
long long blocks_for(long long bytes) {
  const long long per = static_cast<long long>(THREADS) * BATCH * 8;
  return bytes <= 0 ? 1 : (bytes + per - 1) / per;
}

template <int QB, int NB>
cudaError_t launch_tail(const Table& tab, const TailArgs& a, const Frame& fr,
                        int n_streams, cudaStream_t stream) {
  constexpr int c = CLUSTER;
  long long x = 0;
  if (fr.chunk != nullptr && fr.n_in > 0) {
    x = (blocks_for(input_bytes(fr)) + c - 1) / c;
    if (x > MAX_COPY_CLUSTERS) x = MAX_COPY_CLUSTERS;
  }
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr{};
  cfg.gridDim = dim3(c, n_streams + static_cast<int>(x));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, step_tail_kernel<QB, NB>, tab, a, fr,
                            n_streams);
}

// The means' slots a thread takes at once (QB) and the units it holds over
// the barrier (NB, 4 or 8): one instantiation each
template <int QB>
cudaError_t launch_held(const Table& tab, const TailArgs& a, const Frame& fr,
                        int n_streams, cudaStream_t stream) {
  const long long per = static_cast<long long>(CLUSTER) * THREADS;
  const long long need = (tab.units + per - 1) / per;
  if (need <= BATCH)
    return launch_tail<QB, BATCH>(tab, a, fr, n_streams, stream);
  return launch_tail<QB, MAX_B>(tab, a, fr, n_streams, stream);
}

}  // namespace

// The step's tail for S streams: n_leaves leaves (at most MAX_LEAVES) as
// (new, fallback, state, fresh, dst) pointers (fresh null: no reset), bytes
// a stream, kinds and rows (0, 1: the pose's t and q; -1 elsewhere); `in`:
// status, frame_number, matches, the state's map and staged validity, the
// bookkept map's age, match_idx, d1, d2, obs, the features' validity, the
// new map's size, inliers, points inserted, the wide radius used, local
// BA's run (null: no BA), the fresh state's frame_number and status (null:
// no reset); `out`: the new state's frame_number and status; `chunk`: the
// runner's table (null: `rows` is where the pose and StepMetrics' 14 leaves
// go, each [S]; null there: nowhere); row_bytes a stream's; the runner's
// input buffers and a frame's bytes of each (n_in, with a chunk). Any M;
// a source may overlap a buffer other than its own only where a stream's
// units fit the cluster (lvt_tail_shape's out[4]; the wrapper checks).
extern "C" int lvt_step_tail(const void* const* leaf_ptrs,
                             const long long* leaf_bytes,
                             const int* leaf_kinds, const int* leaf_rows,
                             int n_leaves, const void* const* in,
                             void* const* out, void* chunk, void* const* rows,
                             const long long* row_bytes, void* const* in_dst,
                             const long long* in_bytes, int n_in,
                             int n_streams, int m, int n, int k,
                             int min_matches, void* stream) {
  if (n_leaves > MAX_LEAVES || n_in > MAX_INPUTS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_streams <= 0) return static_cast<int>(cudaGetLastError());
  long long p = 1;
  while (p < m) p *= 2;
  TailArgs a{};
  a.ge = static_cast<int>(p < CLUSTER ? p : CLUSTER);
  a.te = static_cast<int>(p / a.ge < THREADS ? p / a.ge : THREADS);
  const long long q = p / (static_cast<long long>(a.ge) * a.te);
  if (q / QMAX > (1ll << (STACK - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.q_len = static_cast<int>(q);
  const Table tab =
      make_table(leaf_ptrs, leaf_bytes, leaf_kinds, leaf_rows, n_leaves);
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
  a.fresh_frame = static_cast<const int*>(in[16]);
  a.fresh_status = static_cast<const int*>(in[17]);
  a.frame_out = static_cast<int*>(out[0]);
  a.status_out = static_cast<int*>(out[1]);
  a.m = m;
  a.n = n;
  a.k = k;
  a.min_matches = min_matches;
  const Frame fr = make_frame(chunk, rows, row_bytes, in_dst, in_bytes, n_in);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (q < QMAX ? q : QMAX) {
    case 1: err = launch_held<1>(tab, a, fr, n_streams, st); break;
    case 2: err = launch_held<2>(tab, a, fr, n_streams, st); break;
    case 4: err = launch_held<4>(tab, a, fr, n_streams, st); break;
    default: err = launch_held<8>(tab, a, fr, n_streams, st);
  }
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}

// The runner's copies. mode PLAIN: n_leaves leaves (at most MAX_LEAVES)
// copied whole, (src, dst) pointers and bytes; FRAME: the same, a leaf with
// a row (rows[i] >= 0, dst null) into row i of the chunk's outputs at
// `chunk` (i from the tickets; row_bytes: a row's), then frame i + 1's
// inputs into the buffers in_dst; START: the chunk's table at `chunk` (its
// n_frames, rows and inputs chunk_in, its tickets and frames 0) and frame
// 0's inputs copied
extern "C" int lvt_copy_leaves(const void* const* ptrs,
                               const long long* bytes, const int* rows,
                               int n_leaves, void* chunk,
                               const long long* row_bytes,
                               void* const* in_dst, const long long* in_bytes,
                               int n_in, void* const* chunk_rows,
                               const void* const* chunk_in, int n_frames,
                               int mode, void* stream) {
  if (n_leaves > MAX_LEAVES || n_in > MAX_INPUTS ||
      (mode != PLAIN && chunk == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* five[5 * MAX_LEAVES];
  int kinds[MAX_LEAVES];
  for (int i = 0; i < n_leaves; ++i) {
    five[5 * i] = five[5 * i + 1] = five[5 * i + 2] = five[5 * i + 3] =
        ptrs[2 * i];
    five[5 * i + 4] = ptrs[2 * i + 1];
    kinds[i] = COPY;
  }
  const Table tab = make_table(five, bytes, kinds, rows, n_leaves);
  const Frame fr = make_frame(chunk, nullptr, row_bytes, in_dst, in_bytes,
                              mode == PLAIN ? 0 : n_in);
  Chunk start{};
  if (mode == START) {
    start.n = n_frames;
    for (int r = 0; r < ROWS; ++r)
      start.row[r] = static_cast<uint8_t*>(chunk_rows[r]);
    for (int j = 0; j < n_in; ++j)
      start.in[j] = static_cast<const uint8_t*>(chunk_in[j]);
  }
  long long blocks = mode == START
                         ? blocks_for(input_bytes(fr))
                         : (tab.units + THREADS * BATCH - 1) / (THREADS * BATCH);
  if (mode == FRAME && blocks_for(input_bytes(fr)) > blocks)
    blocks = blocks_for(input_bytes(fr));
  if (blocks < 1) blocks = 1;
  if (blocks > MAX_COPY_BLOCKS) blocks = MAX_COPY_BLOCKS;
  if (mode == PLAIN && tab.units == 0) return static_cast<int>(cudaGetLastError());
  copy_leaves_kernel<<<static_cast<int>(blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(tab, fr, start,
                                                            mode);
  return static_cast<int>(cudaGetLastError());
}

// The kernels' limits: out[0] leaves a launch, out[1] a chunk's table's
// bytes, out[2] rows, out[3] a frame's inputs, out[4] the units of a
// stream's state that step_tail holds over its barrier
extern "C" int lvt_tail_shape(int* out) {
  out[0] = MAX_LEAVES;
  out[1] = static_cast<int>(sizeof(Chunk));
  out[2] = ROWS;
  out[3] = MAX_INPUTS;
  out[4] = CLUSTER * THREADS * MAX_B;
  return 0;
}
