// Kernel CS for Hopper: per-cell corner selection, the custom op
// lvt_tpu_torch::select_corners (lvt_tpu_torch/ops/detect.py).
//
// Replaces no TPU kernel: lvt_tpu runs this work as XLA ops under jit
// (lvt_tpu/ops/detect.py:280-382 ``select_corners``, called at
// lvt_tpu/core/extract.py:115 and :168-189 with the padding to the slot
// capacity and ``clamp_coords``). In the port it was ~150 small torch
// launches a frame; here it is one launch for all images.
//
// What it computes, per image b of B: the NMS map [H, W] padded with zeros
// to the cell grid (ncy * s_y rows, ncx * s_x columns), plus the plateau
// dither with ``spread``, each cell's max_per_cell (k) largest keys, in
// descending key order, where a pixel's key is the order-preserving
// integer image of (v + 0.0)'s bits in the upper 32 bits and the reversed
// cell-local index n - 1 - i in the lower 32 (detect.py's
// top_k_lowest_index_first): keys are unique, so the selection is exact and
// ties go to the lower index. Each slot (cell-major, rank within the cell)
// gets the corner clamped to the image, its score (the map value, the
// dither added and taken off again, as the plain version's f32 ops round
// it), ``clamp_coords``' patch corner and, given the raw score map, the
// parabolic subpixel position on it (__fmul_rn / __fsub_rn / __fadd_rn /
// __fdiv_rn: nvcc contracts nothing, so each rounding is torch's). The
// low-corner fallback is per image: when fewer than low_count of its
// selected slots score above t, ``valid`` compares against t_low. Slots
// past ncells * k are zero. Given kernel B's bit planes (the dense mode),
// each slot also gets its 8 descriptor words read from the planes at its
// corner (lvt_tpu/ops/brief.py:234-251 descriptors_from_planes, at the
// integer corner, which the rounding and the clamps leave as it is), and
// the descriptor's validity: ``valid`` and the corner at least BORDER
// pixels inside the image; the words are zero where that is false.
//
// Design: one thread-block cluster per cell (grid (C, cells, images),
// C = 8 blocks, 16 where a cell's rows need it). Block rank r owns the
// cell's rows [r R, (r + 1) R), a contiguous range of cell-local index,
// and keeps each pixel's 32-bit order-preserving value (the key's upper
// half) in shared memory, read two rows a warp at a time, the top digit
// counted as it loads; the reversed index is the value's position. The
// cluster selects the k-th largest value T by a radix select, 8 bits a
// pass from the top: each block histograms its values that share the
// prefix so far, the blocks' histograms are added through distributed
// shared memory (integer sums, so their order does not matter) and every
// block finds the same digit; a pass stops once the digit's bin holds
// exactly what is still needed. The pixels above T are taken; the ones equal to T (a bin not
// exhausted after 32 bits) are cut lowest cell index first, by a prefix
// over the ranks' counts in rank order and over the threads' contiguous
// chunks within a block. A survivor's slot is the count of the cell's
// survivors with a larger key: each block copies the cell's (at most k)
// survivors out of the others' shared memory and counts, and writes its
// own survivors' slots. The low-corner fallback needs every cell of an
// image: each block adds its count above t to a per-image counter, and
// rank 0 of each cluster counts the cluster in on a per-image arrival
// counter (both zeroed by a memset node queued before the launch, so a
// CUDA graph replays it); the image's last cluster writes ``valid`` and
// the pad slots with all its blocks. No scratch in device memory besides
// the counters. A block has 512 threads where the card runs all of a
// launch's clusters at once, else 256 (fewer registers a block: more
// clusters at once; path 3's 160 clusters). scripts/torch_select_clocks.py
// stamps each phase's clocks per block.
//
// What bounds it: the maps (3.7 MB for a KITTI pair) are read once; the
// select's passes run in shared memory, so the work is a few shared-memory
// sweeps per pixel, one exchange of histograms per pass and one of the
// survivors per cell. On the card the chain of cluster barriers sets its
// time: a pass costs about 5k cycles, its count, its barrier and exchange
// and its digit (scripts/torch_select_clocks.py); gathering a small bin's
// values across the cluster to cut passes cost more than the passes on
// path 1's frames.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// a block's threads: 512, or 256 where a launch has more clusters than the
// card runs at once at 512 (256 threads take fewer registers a block: more
// clusters at once, each slower; the wrapper picks)
constexpr int THREADS_WIDE = 512;
constexpr int THREADS_NARROW = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int UNROLL = 8;            // loads a lane has in flight in a row
constexpr int BATCH = 8;             // shared-memory reads a lane batches
constexpr int SMEM_MAX = 232448;     // shared memory a block may take
constexpr int SMEM_STATIC = 8192;    // ... of which the static arrays' share
constexpr int CLUSTER_PORTABLE = 8;
constexpr int CLUSTER_MAX = 16;
constexpr int DESC_WORDS = 8;        // a descriptor's words: B's planes
constexpr int BORDER = 20;           // ops/brief.py BORDER

typedef unsigned long long u64;

// Phase markers: nothing here; scripts/torch_select_clocks.py defines them
// to stamp the SM clock in each block
#ifndef SELECT_CLOCK
#define SELECT_CLOCK(slot)
#endif

struct Geometry {
  int h, w;            // the map (the image)
  int s_y, s_x;        // a cell
  int ncx, ncells;     // cells per grid row, per image
  int n;               // pixels per cell
  int k;               // slots per cell
  int cluster;         // blocks per cell
  int rows;            // cell rows per block (R)
  int cap;             // slots per image
};

struct Params {
  float t, t_low;      // the threshold and the fallback's
  int low_count;       // corners_low_threshold
  int spread;          // spread_ties: the plateau dither
  int x0, x1, y0, y1;  // clamp_coords' bounds
};

struct Out {
  int* xi;
  int* yi;
  int* xc;
  int* yc;
  float* score;
  uint8_t* valid;
  float* kp;       // [B, cap, 2] subpixel, or null
  float* corner;   // [B, cap, 2] the integer corner as f32, or null
  const int* planes;   // [B, 8, h, w] kernel B's planes, or null
  int* desc;           // [B, cap, 8] the descriptors (with the planes)
  uint8_t* dvalid;     // [B, cap] the descriptors' validity
};

// detect._bitrev8 of an int's low byte
__device__ __forceinline__ unsigned bitrev8(int v) {
  return __brev(static_cast<unsigned>(v) & 0xffu) >> 24;
}

// detect._dither_at: exact (an integer below 2^15 times 2^-15)
__device__ __forceinline__ float dither_at(int y, int x) {
  const unsigned key = bitrev8(y) * 128u + (bitrev8(x) >> 1);
  return __fmul_rn(static_cast<float>(key), 1.0f / 32768.0f);
}

// The map value at grid pixel (y, x): zero in the pad
__device__ __forceinline__ float map_at(const float* img, const Geometry& g,
                                        int y, int x) {
  return y < g.h && x < g.w ? img[static_cast<long long>(y) * g.w + x]
                            : 0.0f;
}

// The upper half of top_k_lowest_index_first's key of value v: the
// order-preserving image of its bits as an unsigned integer (the signed
// image with its sign bit flipped)
__device__ __forceinline__ unsigned value_of(float v) {
  int bits = __float_as_int(__fadd_rn(v, 0.0f));   // folds -0.0 into +0.0
  if (bits < 0) bits ^= 0x7fffffff;
  return static_cast<unsigned>(bits) ^ 0x80000000u;
}

// detect._parab_offset: (sm - 2 s0) + sp, 0.5 (sm - sp) / denom, clamped
// (torch.clamp keeps a NaN)
__device__ __forceinline__ float parab(float sm, float s0, float sp) {
  const float denom = __fadd_rn(__fsub_rn(sm, __fmul_rn(2.0f, s0)), sp);
  const bool small = fabsf(denom) < 1e-6f;
  const float off =
      __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(sm, sp)), small ? 1e-6f : denom);
  const float r = small ? 0.0f : off;
  return r != r ? r : fminf(fmaxf(r, -0.5f), 0.5f);
}

// The block's exclusive prefix of one int per thread in thread order, and
// the block's total (two barriers)
template <int THREADS>
__device__ __forceinline__ int block_scan(int mine, int* warp_sums,
                                          int& total) {
  constexpr int WARPS = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = incl - mine;
  total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int s = warp_sums[w];
    if (w < warp) before += s;
    total += s;
  }
  __syncthreads();
  return before;
}

// Appends `key` to out[*counter ...) where `take` (one shared atomic per
// warp); every lane of the warp calls it
__device__ __forceinline__ void append(bool take, u64 key, u64* out,
                                       int* counter) {
  const int lane = threadIdx.x & 31;
  const unsigned ballot = __ballot_sync(FULL, take);
  int at = 0;
  if (lane == 0 && ballot) at = atomicAdd(counter, __popc(ballot));
  at = __shfl_sync(FULL, at, 0);
  if (take) out[at + __popc(ballot & ((1u << lane) - 1u))] = key;
}

// The keys of every block's list (list[0, *n) in each block of the
// cluster) into out[0, total), rank by rank; every thread calls it
template <int C, int THREADS>
__device__ void copy_ranks(cg::cluster_group& cluster, u64* list, int* n,
                           u64* out, int total) {
  int end[C];   // rank q's keys end at out[end[q]]
#pragma unroll
  for (int q = 0; q < C; ++q) end[q] = *cluster.map_shared_rank(n, q);
#pragma unroll
  for (int q = 1; q < C; ++q) end[q] += end[q - 1];
  for (int e = threadIdx.x; e < total; e += THREADS) {
    int q = 0, at = e;
#pragma unroll
    for (int r = 0; r < C - 1; ++r) {
      if (e >= end[r]) {
        q = r + 1;
        at = e - end[r];
      }
    }
    out[e] = cluster.map_shared_rank(list, q)[at];
  }
}

// How many of keys[0, n) exceed `key`, a lane's share each, summed over
// the warp (every lane gets it); every lane of the warp calls it
__device__ __forceinline__ int count_above(const u64* keys, int n, u64 key,
                                           int lane) {
  int r = 0, r1 = 0, r2 = 0, r3 = 0;
  int j = lane;
  for (; j + 96 < n; j += 128) {
    r += keys[j] > key;
    r1 += keys[j + 32] > key;
    r2 += keys[j + 64] > key;
    r3 += keys[j + 96] > key;
  }
  for (; j < n; j += 32) r += keys[j] > key;
  r += (r1 + r2) + r3;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) r += __shfl_xor_sync(FULL, r, o);
  return r;
}

// Slot `at` of the selected key: the corner (clamped to the image), the
// score, the patch corner and, with the raw map, the subpixel position.
// Returns whether the score is above t (the fallback's count).
__device__ int write_slot(const float* img, const float* raw,
                          const Geometry& g, const Params& p, const Out& o,
                          long long at, int cy, int cx, u64 key) {
  const int i = g.n - 1 - static_cast<int>(key & 0xffffffffu);
  const int ly = i / g.s_x;
  const int y2 = cy * g.s_y + ly, x2 = cx * g.s_x + (i - ly * g.s_x);
  const float v = map_at(img, g, y2, x2);
  float score = v;
  if (p.spread) {
    const float d = dither_at(y2, x2);
    score = __fsub_rn(__fadd_rn(v, d), d);
  }
  const int xi = min(x2, g.w - 1), yi = min(y2, g.h - 1);
  o.xi[at] = xi;
  o.yi[at] = yi;
  o.xc[at] = min(max(xi, p.x0), p.x1);
  o.yc[at] = min(max(yi, p.y0), p.y1);
  o.score[at] = score;
  if (o.kp) {
    // detect._subpixel_refine: the 3-point fits at the corner clamped
    // one pixel inside the map
    const int xs = min(max(xi, 1), g.w - 2), ys = min(max(yi, 1), g.h - 2);
    const float* c = raw + static_cast<long long>(ys) * g.w + xs;
    const float s0 = c[0];
    o.kp[2 * at] = __fadd_rn(static_cast<float>(xi), parab(c[-1], s0, c[1]));
    o.kp[2 * at + 1] =
        __fadd_rn(static_cast<float>(yi), parab(c[-g.w], s0, c[g.w]));
    o.corner[2 * at] = static_cast<float>(xi);
    o.corner[2 * at + 1] = static_cast<float>(yi);
  }
  if (o.planes) {
    // the descriptor at the corner, whose validity the image's last
    // cluster completes; dvalid holds the border test until then
    const long long hw = static_cast<long long>(g.h) * g.w;
    const int* px = o.planes + (at / g.cap) * DESC_WORDS * hw +
                    static_cast<long long>(yi) * g.w + xi;
    int words[DESC_WORDS];
#pragma unroll
    for (int d = 0; d < DESC_WORDS; ++d) words[d] = px[d * hw];
    int4* out = reinterpret_cast<int4*>(o.desc + DESC_WORDS * at);
    out[0] = make_int4(words[0], words[1], words[2], words[3]);
    out[1] = make_int4(words[4], words[5], words[6], words[7]);
    o.dvalid[at] = xi >= BORDER && xi < g.w - BORDER && yi >= BORDER &&
                   yi < g.h - BORDER;
  }
  return score > p.t;
}

// One cluster of C blocks per cell, grid (C, cells, B). Dynamic shared
// memory: the block's survivors' keys [k], the cell's survivors' keys
// [k], the survivors' slots [k] and the block's values [R s_x].
template <int C, int THREADS>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(THREADS)
    select_corners_kernel(const float* __restrict__ map,
                          const float* __restrict__ raw, Geometry g,
                          Params p, int* __restrict__ counters, Out o) {
  constexpr int WARPS = THREADS / 32;
  extern __shared__ u64 dyn[];
  u64* surv = dyn;                 // this block's survivors, in no order
  u64* all = dyn + g.k;            // the cell's, rank by rank
  int* slot = reinterpret_cast<int*>(dyn + 2 * g.k);   // surv[s]'s rank
  unsigned* vals = reinterpret_cast<unsigned*>(slot + g.k);
  __shared__ unsigned hist[2][256];   // a pass's histogram, read remotely
  __shared__ unsigned tot[256];       // the cluster's
  __shared__ int pick[3];
  __shared__ int warp_sums[WARPS];
  __shared__ int n_surv;              // this block's survivors, read remotely
  __shared__ int n_ties;              // its pixels at T, read remotely
  __shared__ int last;                // set by rank 0: the image's last cell
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cell = blockIdx.y, b = blockIdx.z;
  const int cy = cell / g.ncx, cx = cell - cy * g.ncx;
  const long long hw = static_cast<long long>(g.h) * g.w;
  const float* img = map + b * hw;
  int* img_count = counters;                 // [B]
  int* img_arrivals = counters + gridDim.z;  // [B]
  const int r0 = rank * g.rows;
  const int nrows = max(0, min(g.s_y - r0, g.rows));
  const int len = nrows * g.s_x, lo = r0 * g.s_x;

  // the block's values into shared memory, two rows a warp at a time
  // (2 UNROLL loads in flight a lane), their top digit counted on the way
  // (one shared atomic a warp where its digits agree, else one a pixel: on
  // the card that beat one for the lanes sharing lane 0's digit and one for
  // each other lane, scripts/torch_select_clocks.py)
  SELECT_CLOCK(0);
  for (int i = threadIdx.x; i < 256; i += THREADS) hist[0][i] = 0;
  if (threadIdx.x == 0) n_surv = 0;
  __syncthreads();
  for (int row0 = 2 * warp; row0 < nrows; row0 += 2 * WARPS) {
    const int xb = cx * g.s_x;
    for (int c0 = 0; c0 < g.s_x; c0 += 32 * UNROLL) {
      float v[2][UNROLL];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = cy * g.s_y + r0 + row0 + h;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int c = c0 + 32 * u + lane;
          v[h][u] = c < g.s_x && row0 + h < nrows ? map_at(img, g, y, xb + c)
                                                  : 0.0f;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + h, y = cy * g.s_y + r0 + row;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int c = c0 + 32 * u + lane;
          const bool in = c < g.s_x && row < nrows;
          const unsigned act = __ballot_sync(FULL, in);
          if (act == 0) break;
          const float wv =
              p.spread ? __fadd_rn(v[h][u], dither_at(y, xb + c)) : v[h][u];
          const unsigned val = value_of(wv);
          if (in) vals[row * g.s_x + c] = val;
          const unsigned d = val >> 24;
          const unsigned d0 = __shfl_sync(FULL, d, 0);
          if (__all_sync(FULL, !in || d == d0)) {
            if (lane == 0) atomicAdd(&hist[0][d0], __popc(act));
          } else if (in) {
            atomicAdd(&hist[0][d], 1u);
          }
        }
      }
    }
  }
  __syncthreads();

  // the cell's k-th largest value T: a radix select over the cluster
  SELECT_CLOCK(1);
  unsigned pre = 0, msk = 0;
  int need = g.k;
  bool exact = false;
  for (int pass = 0, shift = 24; shift >= 0; ++pass, shift -= 8) {
    unsigned* h = hist[pass & 1];
    if (pass > 0) {   // h was zeroed in the last pass
      for (int base = threadIdx.x; base < len; base += BATCH * THREADS) {
        unsigned u[BATCH];
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
          const int j = base + i * THREADS;
          u[i] = j < len ? vals[j] : ~pre;   // ~pre never has the prefix
        }
#pragma unroll
        for (int i = 0; i < BATCH; ++i)
          if ((u[i] & msk) == pre) atomicAdd(&h[(u[i] >> shift) & 0xffu], 1u);
      }
    }
    SELECT_CLOCK(9 + 3 * pass);
    cluster.sync();
    for (int i = threadIdx.x; i < 256; i += THREADS) {
      unsigned s = 0;
#pragma unroll
      for (int q = 0; q < C; ++q) s += cluster.map_shared_rank(h, q)[i];
      tot[i] = s;
      // the next pass's buffer: every block read it in the last pass,
      // before this pass's cluster barrier
      hist[(pass + 1) & 1][i] = 0;
    }
    __syncthreads();
    SELECT_CLOCK(10 + 3 * pass);
    if (warp == 0) {
      // lane l holds bins 255 - 8 l down to 248 - 8 l
      int c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = static_cast<int>(tot[255 - 8 * lane - j]);
        sum += c[j];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += up;
      }
      int run = incl - sum;
      if (run < need && need <= incl) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (run + c[j] >= need) {
            pick[0] = 255 - 8 * lane - j;
            pick[1] = run;
            pick[2] = c[j];
            break;
          }
          run += c[j];
        }
      }
    }
    __syncthreads();
    SELECT_CLOCK(11 + 3 * pass);
    const int bin = pick[0], above = pick[1], count = pick[2];
    need -= above;
    pre |= static_cast<unsigned>(bin) << shift;
    msk |= 0xffu << shift;
    if (count == need) {
      exact = true;   // the bin is taken whole
      break;
    }
  }

  // the survivors: every value above T (or in T's exhausted bin), then
  // the `need` pixels at T of lowest cell index
  SELECT_CLOCK(2);
  for (int base = 0; base < len; base += BATCH * THREADS) {
    unsigned u[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int j = base + i * THREADS + threadIdx.x;
      u[i] = j < len ? vals[j] : 0u;
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int j = base + i * THREADS + threadIdx.x;
      const bool take =
          j < len && (exact ? (u[i] & msk) >= pre : u[i] > pre);
      append(take, (static_cast<u64>(u[i]) << 32) |
                       static_cast<unsigned>(g.n - 1 - (lo + j)),
             surv, &n_surv);
    }
  }
  if (!exact) {
    // thread t's contiguous chunk of the block's values, in index order
    const int chunk = (len + THREADS - 1) / THREADS;
    const int j0 = min(len, threadIdx.x * chunk), j1 = min(len, j0 + chunk);
    int mine = 0;
    for (int j = j0; j < j1; ++j) mine += vals[j] == pre;
    int ties;
    int before = block_scan<THREADS>(mine, warp_sums, ties);
    if (threadIdx.x == 0) n_ties = ties;
    cluster.sync();
    int below = 0;   // the ties of the lower ranks
    for (int q = 0; q < rank; ++q)
      below += *cluster.map_shared_rank(&n_ties, q);
    const int take = min(ties, max(0, need - below));
    for (int j = j0; j < j1 && before < take; ++j) {
      if (vals[j] == pre) {
        surv[atomicAdd(&n_surv, 1)] =
            (static_cast<u64>(pre) << 32) |
            static_cast<unsigned>(g.n - 1 - (lo + j));
        ++before;
      }
    }
  }
  __syncthreads();

  // the cell's survivors out of every block's shared memory, rank by rank
  SELECT_CLOCK(3);
  cluster.sync();
  copy_ranks<C, THREADS>(cluster, surv, &n_surv, all, g.k);
  cluster.sync();   // no block reads another's shared memory after this

  // each survivor's slot: the survivors of the cell with a larger key
  SELECT_CLOCK(4);
  const int mine_n = n_surv;
  for (int s = warp; s < mine_n; s += WARPS) {   // a warp per survivor
    const int r = count_above(all, g.k, surv[s], lane);
    if (lane == 0) slot[s] = r;
  }
  __syncthreads();
  SELECT_CLOCK(5);
  int above_t = 0;
  for (int s = threadIdx.x; s < mine_n; s += THREADS)
    above_t += write_slot(img, raw ? raw + b * hw : nullptr, g, p, o,
                          static_cast<long long>(b) * g.cap + cell * g.k +
                              slot[s],
                          cy, cx, surv[s]);
  int count;
  block_scan<THREADS>(above_t, warp_sums, count);
  SELECT_CLOCK(6);
  if (threadIdx.x == 0) atomicAdd(&img_count[b], count);
  __threadfence();
  cluster.sync();   // the cell's slots and counts are in device memory
  if (rank == 0 && threadIdx.x == 0) {
    __threadfence();
    const int is_last = atomicAdd(&img_arrivals[b], 1) == g.ncells - 1;
    for (int q = 0; q < C; ++q) *cluster.map_shared_rank(&last, q) = is_last;
  }
  cluster.sync();
  SELECT_CLOCK(7);
  if (!last) return;
  __threadfence();

  // the image's last cell: the fallback, ``valid``, the pad slots, the
  // slots split over the cluster's blocks
  const int n_above = atomicAdd(&img_count[b], 0);
  const float t_eff = n_above < p.low_count ? p.t_low : p.t;
  const int used = g.ncells * g.k;
  const long long row = static_cast<long long>(b) * g.cap;
  const int per = (g.cap + C - 1) / C;
  const int s0 = rank * per, s1 = min(g.cap, s0 + per);
  for (int s = s0 + threadIdx.x; s < s1; s += THREADS) {
    const long long at = row + s;
    if (s < used) {
      const bool v = __ldcg(o.score + at) > t_eff;
      o.valid[at] = v;
      if (o.planes) {
        const bool dv = v && __ldcg(o.dvalid + at);
        o.dvalid[at] = dv;
        if (!dv) {
          int4* out = reinterpret_cast<int4*>(o.desc + DESC_WORDS * at);
          out[0] = out[1] = make_int4(0, 0, 0, 0);
        }
      }
    } else {
      o.xi[at] = 0;
      o.yi[at] = 0;
      o.xc[at] = min(max(0, p.x0), p.x1);
      o.yc[at] = min(max(0, p.y0), p.y1);
      o.score[at] = 0.0f;
      o.valid[at] = 0;
      if (o.kp) {
        o.kp[2 * at] = o.kp[2 * at + 1] = 0.0f;
        o.corner[2 * at] = o.corner[2 * at + 1] = 0.0f;
      }
      if (o.planes) {
        int4* out = reinterpret_cast<int4*>(o.desc + DESC_WORDS * at);
        out[0] = out[1] = make_int4(0, 0, 0, 0);
        o.dvalid[at] = 0;
      }
    }
  }
  SELECT_CLOCK(8);
}

// Dynamic shared memory of a block holding `px` values of a cell keeping k
long long smem_bytes(long long px, int k) { return 20ll * k + 4 * px; }

// The launch's geometry for an h x w map, or false where a bound is
// exceeded (the wrapper checks first and raises)
bool geometry(int h, int w, int cell_size, int k, int cap, Geometry& g) {
  if (h < 1 || w < 1 || cell_size < 1 || k < 1) return false;
  g.h = h;
  g.w = w;
  g.s_x = cell_size < w ? cell_size : w;
  g.s_y = cell_size < h ? cell_size : h;
  const int ncy = (h + g.s_y - 1) / g.s_y;
  g.ncx = (w + g.s_x - 1) / g.s_x;
  g.ncells = ncy * g.ncx;
  g.n = g.s_y * g.s_x;
  g.k = k;
  g.cap = cap;
  g.cluster = CLUSTER_PORTABLE;
  g.rows = (g.s_y + g.cluster - 1) / g.cluster;
  if (smem_bytes(static_cast<long long>(g.rows) * g.s_x, k) >
      SMEM_MAX - SMEM_STATIC) {
    g.cluster = CLUSTER_MAX;
    g.rows = (g.s_y + g.cluster - 1) / g.cluster;
  }
  return k <= g.n &&
         smem_bytes(static_cast<long long>(g.rows) * g.s_x, k) <=
             SMEM_MAX - SMEM_STATIC &&
         static_cast<long long>(g.ncells) * k <= cap && g.ncells <= 65535;
}

template <int C, int THREADS>
cudaError_t prepare(const Geometry& g) {
  const int smem = static_cast<int>(
      smem_bytes(static_cast<long long>(g.rows) * g.s_x, g.k));
  cudaError_t err = cudaFuncSetAttribute(
      select_corners_kernel<C, THREADS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && C > CLUSTER_PORTABLE)
    err = cudaFuncSetAttribute(select_corners_kernel<C, THREADS>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  return err;
}

template <int C, int THREADS>
int max_active_clusters(const Geometry& g, int batch) {
  if (prepare<C, THREADS>(g) != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, g.ncells, batch);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes =
      smem_bytes(static_cast<long long>(g.rows) * g.s_x, g.k);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, select_corners_kernel<C, THREADS>,
                                     &cfg) != cudaSuccess)
    return -1;
  return n;
}

template <int C, int THREADS>
cudaError_t launch(const Geometry& g, int batch, const float* map,
                   const float* raw, const Params& p, int* counters,
                   const Out& o, cudaStream_t s) {
  const cudaError_t err = prepare<C, THREADS>(g);
  if (err != cudaSuccess) return err;
  select_corners_kernel<C, THREADS>
      <<<dim3(C, g.ncells, batch), THREADS,
         smem_bytes(static_cast<long long>(g.rows) * g.s_x, g.k), s>>>(
          map, raw, g, p, counters, o);
  return cudaGetLastError();
}

}  // namespace

// The geometry of a launch on [B, h, w] maps: out[0] cells per image,
// out[1] blocks per cell (the cluster), out[2] cell rows per block, out[3]
// pixels per block, out[4] dynamic shared memory bytes, out[5] the most
// pixels a block may hold at this k, out[6] threads per block at most
// (the wrapper takes fewer where lvt_select_max_clusters says so). Returns 0,
// or 1 where a bound is exceeded (out[5] then says how many pixels a block
// may hold, out[1] the largest cluster).
extern "C" int lvt_select_geometry(int h, int w, int cell_size, int k,
                                   int cap, int* out) {
  Geometry g{};
  const bool ok = geometry(h, w, cell_size, k, cap, g);
  out[0] = g.ncells;
  out[1] = g.cluster;
  out[2] = g.rows;
  out[3] = g.rows * g.s_x;
  out[4] = static_cast<int>(
      smem_bytes(static_cast<long long>(g.rows) * g.s_x, k));
  const long long most = (SMEM_MAX - SMEM_STATIC - smem_bytes(0, k)) / 4;
  out[5] = static_cast<int>(most > 0 ? most : 0);
  out[6] = THREADS_WIDE;
  return ok ? 0 : 1;
}

// How many of a launch's clusters of blocks of `threads` (512 or 256) the
// card runs at once (cudaOccupancyMaxActiveClusters at its shared memory),
// or -1
extern "C" int lvt_select_max_clusters(int batch, int h, int w,
                                       int cell_size, int k, int cap,
                                       int threads) {
  Geometry g;
  if (!geometry(h, w, cell_size, k, cap, g)) return -1;
  const bool wide = threads == THREADS_WIDE;
  if (!wide && threads != THREADS_NARROW) return -1;
  if (g.cluster == CLUSTER_PORTABLE)
    return wide ? max_active_clusters<CLUSTER_PORTABLE, THREADS_WIDE>(g, batch)
                : max_active_clusters<CLUSTER_PORTABLE, THREADS_NARROW>(g,
                                                                      batch);
  return wide ? max_active_clusters<CLUSTER_MAX, THREADS_WIDE>(g, batch)
              : max_active_clusters<CLUSTER_MAX, THREADS_NARROW>(g, batch);
}

// CS: the NMS map [B, h, w] f32 (and the raw score map, or null; and
// kernel B's planes [B, 8, h, w] int32, or null) -> the slots [B, cap]:
// xi, yi, xc, yc int32, score f32, valid bool, with the raw map kp and
// corner [B, cap, 2] f32, with the planes desc [B, cap, 8] int32 and its
// validity [B, cap]; blocks of `threads` (512 or 256). counters: [2 B]
// int32 scratch, zeroed here by a memset node on the stream. Grid
// (cluster, cells, B).
extern "C" int lvt_select_corners(
    const float* map, const float* raw, int batch, int h, int w,
    int cell_size, int k, int cap, int threads, float t, float t_low,
    int low_count, int spread, int x0, int x1, int y0, int y1,
    const int* planes, int* counters, int* xi, int* yi, int* xc, int* yc,
    float* score, void* valid, float* kp, float* corner, int* desc,
    void* dvalid, void* stream) {
  Geometry g;
  if (!geometry(h, w, cell_size, k, cap, g) ||
      (threads != THREADS_WIDE && threads != THREADS_NARROW) ||
      (planes != nullptr && (raw == nullptr || desc == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch < 1) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      counters, 0, sizeof(int) * 2 * static_cast<size_t>(batch), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{t, t_low, low_count, spread, x0, x1, y0, y1};
  const Out o{xi,     yi,     xc,   yc,     score, static_cast<uint8_t*>(valid),
              kp,     corner, planes, desc,
              static_cast<uint8_t*>(dvalid)};
  const bool wide = threads == THREADS_WIDE;
  if (g.cluster == CLUSTER_PORTABLE) {
    err = wide ? launch<CLUSTER_PORTABLE, THREADS_WIDE>(g, batch, map, raw, p,
                                                        counters, o, s)
               : launch<CLUSTER_PORTABLE, THREADS_NARROW>(g, batch, map, raw,
                                                          p, counters, o, s);
  } else {
    err = wide ? launch<CLUSTER_MAX, THREADS_WIDE>(g, batch, map, raw, p,
                                                   counters, o, s)
               : launch<CLUSTER_MAX, THREADS_NARROW>(g, batch, map, raw, p,
                                                     counters, o, s);
  }
  return static_cast<int>(err);
}
