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
// past ncells * k are zero.
//
// Design: a cell (62,500 px on KITTI, 307,200 in TUM's one cell) is split
// into `tiles` tiles of about TILE_TARGET pixels (fewer, larger tiles where
// tiles * k candidates would not fit a block's merge), one block of
// THREADS each (grid (tiles, cells, images)). A block loads its tile's
// keys into shared memory, counting their top digit as it goes, and keeps
// the tile's top k: a radix select, 8 bits a pass from the top, with an
// early exit once the bin holds exactly what is still needed (per-tile
// top-k is exact: the cell's top k lies in the union of its tiles'), its
// candidates written to a global scratch. The last block of a cell to
// finish (an atomic arrival count) merges the candidates the same way,
// sorts the k survivors (a bitonic network in shared memory) and writes
// the cell's slots; the last cell of an image to finish writes the
// image's ``valid`` and its pad slots. The counters are zeroed by a memset
// node queued before the launch (no kernel, so a CUDA graph replays it;
// the scratch is the wrapper's, so concurrent launches share nothing).
// scripts/torch_select_clocks.py stamps each phase's clocks per block.
//
// What bounds it: the maps (3.7 MB for a KITTI pair) are read once; the
// select's passes run in shared memory, so the work is a few shared-memory
// sweeps per pixel and the block-serial merge of each cell's candidates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE_TARGET = 4096;   // pixels a tile aims at
constexpr int MAX_TILE = 24576;     // pixels a tile may hold (192 KB of keys)
constexpr int MAX_CAND = 16384;     // candidates a cell's merge may hold
constexpr int SMEM_KEYS = 28672;    // keys in a block's dynamic shared memory
constexpr int UNROLL = 8;           // loads a thread has in flight

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
  int tiles, tile;     // blocks per cell, pixels per tile (the last fewer)
  int kt;              // candidates a full tile keeps: min(k, tile)
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

// top_k_lowest_index_first's key of value v at cell index i, as an
// unsigned 64-bit integer (the signed key with its sign bit flipped)
__device__ __forceinline__ u64 key_of(float v, int rev) {
  int bits = __float_as_int(__fadd_rn(v, 0.0f));   // folds -0.0 into +0.0
  if (bits < 0) bits ^= 0x7fffffff;
  return (static_cast<u64>(static_cast<unsigned>(bits) ^ 0x80000000u) << 32) |
         static_cast<unsigned>(rev);
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

// The selection of radix_select: the keys with (key & msk) >= pre
struct Sel {
  u64 pre, msk;
};

// The `need` largest of the unique keys keys[0, len) (1 <= need <= len),
// 8 bits a pass from the top: each pass histograms the keys that share the
// prefix so far (one shared atomic per key: on the card that beat one per
// warp and digit, whether by __match_any_sync or by a warp vote on one
// digit, scripts/torch_select_clocks.py), and warp 0 finds the bin where
// the count from the top reaches `need`.
// Every key of a higher bin is taken; the pass stops once the bin holds
// exactly what is still needed. `hist` holds the top digit's histogram
// already (the caller counted it as it loaded the keys). Every thread
// calls it.
__device__ Sel radix_select(const u64* keys, int len, int need,
                            unsigned* hist, int* pick) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  u64 pre = 0, msk = 0;
  for (int shift = 56; shift >= 0; shift -= 8) {
    if (shift < 56) {
      for (int i = threadIdx.x; i < 256; i += THREADS) hist[i] = 0;
      __syncthreads();
      for (int i = threadIdx.x; i < len; i += THREADS) {
        const u64 key = keys[i];
        if ((key & msk) == pre) atomicAdd(&hist[(key >> shift) & 0xffu], 1u);
      }
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 255 - 8 l down to 248 - 8 l
      int c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = static_cast<int>(hist[255 - 8 * lane - j]);
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
    const int bin = pick[0], above = pick[1], count = pick[2];
    need -= above;
    pre |= static_cast<u64>(bin) << shift;
    msk |= 0xffull << shift;
    if (count == need) break;
  }
  return Sel{pre, msk};
}

// The selected keys of keys[0, len) into out[*counter ...), in no order
// (one shared atomic per warp); *counter must be 0 and the keys visible
// to every thread. Every thread calls it.
__device__ void compact(const u64* keys, int len, Sel s, u64* out,
                        int* counter) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < len; base += THREADS) {
    const int i = base + threadIdx.x;
    const u64 key = i < len ? keys[i] : 0;
    const bool take = i < len && (key & s.msk) >= s.pre;
    const unsigned ballot = __ballot_sync(FULL, take);
    int at = 0;
    if (lane == 0 && ballot) at = atomicAdd(counter, __popc(ballot));
    at = __shfl_sync(FULL, at, 0);
    if (take) out[at + __popc(ballot & ((1u << lane) - 1u))] = key;
  }
}

// The block's sum of one int per thread (two barriers)
__device__ __forceinline__ int block_sum(int mine, int* warp_sums) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mine += __shfl_xor_sync(FULL, mine, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = mine;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) total += warp_sums[w];
  __syncthreads();
  return total;
}

// a[0, p) (p a power of two) sorted into descending order: a bitonic
// network, one compare-exchange per thread and pair (on the card it beat
// ranking by counting, scripts/torch_select_clocks.py). Every thread
// calls it.
__device__ void sort_desc(u64* a, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < p / 2; t += THREADS) {
        const int lo = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const u64 x = a[lo], y = a[lo + stride];
        if ((x < y) == ((lo & size) == 0)) {
          a[lo] = y;
          a[lo + stride] = x;
        }
      }
      __syncthreads();
    }
  }
}

// The smallest power of two >= n
__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
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
  return score > p.t;
}

__global__ void __launch_bounds__(THREADS) select_corners_kernel(
    const float* __restrict__ map, const float* __restrict__ raw, Geometry g,
    Params p, u64* __restrict__ cand, int* __restrict__ counters, Out o) {
  // the tile's keys; in the merge the cell's candidates, then its top k
  extern __shared__ u64 keys[];
  __shared__ unsigned hist[256];
  __shared__ int pick[3];
  __shared__ int warp_sums[WARPS];
  __shared__ int counter;
  __shared__ int last;
  const int tile = blockIdx.x, cell = blockIdx.y, b = blockIdx.z;
  const int cy = cell / g.ncx, cx = cell - cy * g.ncx;
  const long long hw = static_cast<long long>(g.h) * g.w;
  const float* img = map + b * hw;
  const long long cell_id = static_cast<long long>(b) * g.ncells + cell;
  int* arrivals = counters;                          // [B * ncells]
  int* img_count = counters + g.ncells * gridDim.z;  // [B]
  int* img_arrivals = img_count + gridDim.z;         // [B]

  // the tile's top candidates: its keys into shared memory (UNROLL loads in
  // flight a thread), their top digit counted on the way
  SELECT_CLOCK(0);
  for (int i = threadIdx.x; i < 256; i += THREADS) hist[i] = 0;
  if (threadIdx.x == 0) counter = 0;
  __syncthreads();
  const int lo = tile * g.tile, len = min(g.n - lo, g.tile);
  for (int base = 0; base < len; base += THREADS * UNROLL) {
    float v[UNROLL];
    int yx[UNROLL][2];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = lo + base + u * THREADS + threadIdx.x;
      const int ly = i / g.s_x;
      yx[u][0] = cy * g.s_y + ly;
      yx[u][1] = cx * g.s_x + (i - ly * g.s_x);
      v[u] = i < lo + len ? map_at(img, g, yx[u][0], yx[u][1]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + u * THREADS + threadIdx.x;
      const float w = p.spread ? __fadd_rn(v[u], dither_at(yx[u][0],
                                                           yx[u][1]))
                               : v[u];
      if (j < len) {
        const u64 key = key_of(w, g.n - 1 - (lo + j));
        keys[j] = key;
        atomicAdd(&hist[key >> 56], 1u);
      }
    }
  }
  __syncthreads();
  SELECT_CLOCK(1);
  const Sel tile_sel = radix_select(keys, len, min(g.k, len), hist, pick);
  SELECT_CLOCK(2);
  compact(keys, len, tile_sel, cand + (cell_id * g.tiles + tile) * g.kt,
          &counter);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&arrivals[cell_id], 1) == g.tiles - 1;
  __syncthreads();
  SELECT_CLOCK(3);
  if (!last) return;
  __threadfence();

  // the cell's last block: its tiles' candidates (contiguous: only the
  // last tile may keep fewer than kt), their top k, sorted
  const int total = (g.tiles - 1) * g.kt +
                    min(g.k, g.n - (g.tiles - 1) * g.tile);
  const u64* src = cand + cell_id * g.tiles * g.kt;
  for (int i = threadIdx.x; i < 256; i += THREADS) hist[i] = 0;
  if (threadIdx.x == 0) counter = 0;
  __syncthreads();
#pragma unroll UNROLL
  for (int j = threadIdx.x; j < total; j += THREADS) {
    const u64 key = __ldcg(src + j);
    keys[j] = key;
    atomicAdd(&hist[key >> 56], 1u);
  }
  const int p2 = pow2_at_least(g.k);
  u64* top = keys + total;
  for (int j = g.k + threadIdx.x; j < p2; j += THREADS) top[j] = 0;
  __syncthreads();
  SELECT_CLOCK(4);
  compact(keys, total, radix_select(keys, total, g.k, hist, pick), top,
          &counter);
  __syncthreads();
  SELECT_CLOCK(5);
  sort_desc(top, p2);
  SELECT_CLOCK(6);
  int above_t = 0;
  for (int r = threadIdx.x; r < g.k; r += THREADS)
    above_t += write_slot(img, raw ? raw + b * hw : nullptr, g, p, o,
                          static_cast<long long>(b) * g.cap + cell * g.k + r,
                          cy, cx, top[r]);
  __threadfence();
  const int count = block_sum(above_t, warp_sums);
  SELECT_CLOCK(7);
  if (threadIdx.x == 0) {
    atomicAdd(&img_count[b], count);
    __threadfence();
    last = atomicAdd(&img_arrivals[b], 1) == g.ncells - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the image's last cell: the fallback, ``valid``, the pad slots
  const int n_above = atomicAdd(&img_count[b], 0);
  const float t_eff = n_above < p.low_count ? p.t_low : p.t;
  const int used = g.ncells * g.k;
  const long long row = static_cast<long long>(b) * g.cap;
  for (int base = 0; base < used; base += THREADS * UNROLL) {
    float sc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = base + u * THREADS + threadIdx.x;
      sc[u] = s < used ? __ldcg(o.score + row + s) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = base + u * THREADS + threadIdx.x;
      if (s < used) o.valid[row + s] = sc[u] > t_eff;
    }
  }
  for (int s = used + threadIdx.x; s < g.cap; s += THREADS) {
    const long long at = row + s;
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
  }
  SELECT_CLOCK(8);
}

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
  int tiles = (g.n + TILE_TARGET - 1) / TILE_TARGET;
  const int most = MAX_CAND / k > 1 ? MAX_CAND / k : 1;
  if (tiles > most) tiles = most;
  g.tile = (g.n + tiles - 1) / tiles;
  g.tiles = (g.n + g.tile - 1) / g.tile;
  g.kt = k < g.tile ? k : g.tile;
  const long long merge =
      static_cast<long long>(g.tiles) * g.kt + pow2_at_least(k);
  return k <= g.n && g.tile <= MAX_TILE && merge <= SMEM_KEYS &&
         static_cast<long long>(g.ncells) * k <= cap && g.ncells <= 65535;
}

size_t smem_bytes(const Geometry& g) {
  const int merge = g.tiles * g.kt + pow2_at_least(g.k);
  return sizeof(u64) * (g.tile > merge ? g.tile : merge);
}

}  // namespace

// The geometry of a launch on [B, h, w] maps: out[0] cells per image,
// out[1] tiles (blocks) per cell, out[2] candidates per tile (the
// scratch's [B, cells, tiles, out[2]] keys), out[3] pixels per tile,
// out[4] dynamic shared memory bytes. Returns 0, or 1 where a bound is
// exceeded.
extern "C" int lvt_select_geometry(int h, int w, int cell_size, int k,
                                   int cap, int* out) {
  Geometry g;
  if (!geometry(h, w, cell_size, k, cap, g)) return 1;
  out[0] = g.ncells;
  out[1] = g.tiles;
  out[2] = g.kt;
  out[3] = g.tile;
  out[4] = static_cast<int>(smem_bytes(g));
  return 0;
}

// CS: the NMS map [B, h, w] f32 (and the raw score map, or null) -> the
// slots [B, cap]: xi, yi, xc, yc int32, score f32, valid bool, and with
// the raw map kp and corner [B, cap, 2] f32. cand: the [B, cells, tiles,
// kt] u64 scratch; counters: [B * cells + 2 B] int32 scratch, zeroed here
// by a memset node on the stream. Grid (tiles, cells, B).
extern "C" int lvt_select_corners(
    const float* map, const float* raw, int batch, int h, int w,
    int cell_size, int k, int cap, float t, float t_low, int low_count,
    int spread, int x0, int x1, int y0, int y1, void* cand, int* counters,
    int* xi, int* yi, int* xc, int* yc, float* score, void* valid,
    float* kp, float* corner, void* stream) {
  Geometry g;
  if (!geometry(h, w, cell_size, k, cap, g))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch < 1) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      counters, 0, sizeof(int) * (static_cast<size_t>(batch) * g.ncells +
                                  2 * static_cast<size_t>(batch)), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(g);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(select_corners_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Params p{t, t_low, low_count, spread, x0, x1, y0, y1};
  const Out o{xi, yi, xc, yc, score, static_cast<uint8_t*>(valid), kp, corner};
  select_corners_kernel<<<dim3(g.tiles, g.ncells, batch), THREADS, smem, s>>>(
      map, raw, g, p, static_cast<u64*>(cand), counters, o);
  return static_cast<int>(cudaGetLastError());
}
