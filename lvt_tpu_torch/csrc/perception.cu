// Kernel A for Hopper: 9x9 box sum, FAST-9/16 max-threshold score and
// plateau-collapsing 3x3 NMS, fused in one pass over the image.
//
// Replaces lvt_tpu/ops/perception_pallas.py::_score_smooth_kernel (reached
// through perception_patch_maps_batched). Same semantics, not the same
// blocking: the TPU kernel rolls whole VMEM slabs; here one block owns an
// output tile and stages the image tile plus its halo in shared memory
// with zero padding (the TPU kernel's jnp.pad).
//
// uint8 frames (the main paths), perception_kernel_u8: every value is a
// small integer (pixels <= 255, box sums <= 81 * 255 = 20655 < 2^16), so
// two pixels share one 32-bit register as 16-bit lanes:
//   * box sum: SWAR adds, two sums per 32-bit add; no carry crosses a lane
//     because no lane leaves [0, 65535] (a + b - c is exact for the same
//     reason);
//   * FAST: min and max commute with subtracting the centre, so the arc
//     test runs on the ring pixels themselves, on Hopper's DPX 3-input
//     min/max over two 16-bit lanes (__vimin3_u16x2, __vimax3_u16x2):
//     windows of 3, then of 9 (3 x 3), then the max (min) over the 16
//     arcs, 40 instructions per arc type for two pixels where 2-input
//     windows 2 -> 4 -> 8 -> 9 take 79 each for one. `cuobjdump -sass` of
//     the sm_90a build (scripts/torch_kernel_sass.py) shows each intrinsic
//     as one VIMNMX3.U16x2 instruction, not an emulated sequence.
//     Integer min and max are exact in any grouping, so the bits are the
//     JAX kernel's. The
//     centre comes off once: score = max(bright - c, c - dark, 0), with
//     256 added to each lane so no lane goes negative;
//   * NMS on the packed lanes: keep s where s >= max(before + 1, after),
//     read from bit 8 of s - t + 256 in each lane;
//   * lanes become f32 only at the store (0x4B000000 | v is 2^23 + v).
// A 64x32 tile stages 80x40 pixels (halo 8 columns, so 4-pixel groups
// stay 8-byte aligned in shared memory, and 4 rows); rows of an odd-width
// image start at any byte, so the staging reads bytes, two per 32-bit
// shared word. Each thread stores 4 pixels of each map, one float4 where
// the address is 16-byte aligned (in an odd-width image one row in four);
// staging the maps in shared memory for stores of 32 adjacent floats per
// warp was slower on an H100 (the extra pass and barrier cost more than
// the store transactions they save).
//
// float frames, perception_kernel_f32: one pixel per thread in f32 with the
// JAX kernel's summation order (rows +d then -d, then columns +d then -d);
// no product is formed, so no FMA contraction can change a bit.
//
// What bounds it on the card: device-memory traffic, 1 byte in and 12
// bytes out per pixel for uint8 frames (~50 ALU instructions per pixel).
// The whole KITTI pair is one wave of blocks, so staging, compute and the
// stores run one after the other on every SM instead of overlapping.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- uint8

constexpr int U8_TW = 64;                  // output tile columns
constexpr int U8_TH = 32;                  // output tile rows
constexpr int U8_HX = 8;                   // staged columns left and right
constexpr int U8_HY = 4;                   // staged rows: box 4 = ring 3 + NMS 1
constexpr int U8_SW = (U8_TW + 2 * U8_HX) / 2;   // 40 words (80 pixels)
constexpr int U8_SH = U8_TH + 2 * U8_HY;         // 40 rows
constexpr int U8_GROUPS = U8_TW / 4;             // 16 groups of 4 pixels
constexpr int SC_GROUPS = U8_GROUPS + 2;         // score on columns -4 .. TW+3
constexpr int SC_W = 2 * SC_GROUPS;              // 36 words
constexpr int SC_H = U8_TH + 2;                  // score rows -1 .. TH
constexpr int U8_THREADS = 256;
constexpr uint32_t BIAS = 0x01000100u;           // 256 in both lanes
constexpr int BORDER = 3;                        // FAST ring radius

// w[0..5] hold pixels c - 4 .. c + 7 (c a multiple of 4) as 16-bit pairs;
// pair_at<D> is pixels (c + D, c + D + 1) in one register
template <int D>
__device__ __forceinline__ uint32_t pair_at(const uint32_t (&w)[6]) {
  static_assert(D >= -4 && D <= 6, "outside the loaded words");
  if constexpr (((D + 4) & 1) == 0) {
    return w[(D + 4) / 2];
  } else {
    return __byte_perm(w[(D + 3) / 2], w[(D + 5) / 2], 0x5432);
  }
}

__device__ __forceinline__ void load6(const uint32_t* p, uint32_t (&w)[6]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const uint2 b = *reinterpret_cast<const uint2*>(p + 2);
  const uint2 c = *reinterpret_cast<const uint2*>(p + 4);
  w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y; w[4] = c.x; w[5] = c.y;
}

// the 16 ring pixels of pixels (c + P, c + P + 1), clockwise from (0, -3)
// (lvt_tpu/ops/detect.py RING_OFFSETS); r[0..6] are rows dy = -3 .. 3
template <int P>
__device__ __forceinline__ void ring16(const uint32_t (&r)[7][6],
                                       uint32_t (&d)[16]) {
  d[0] = pair_at<P + 0>(r[0]);   d[1] = pair_at<P + 1>(r[0]);
  d[2] = pair_at<P + 2>(r[1]);   d[3] = pair_at<P + 3>(r[2]);
  d[4] = pair_at<P + 3>(r[3]);   d[5] = pair_at<P + 3>(r[4]);
  d[6] = pair_at<P + 2>(r[5]);   d[7] = pair_at<P + 1>(r[6]);
  d[8] = pair_at<P + 0>(r[6]);   d[9] = pair_at<P - 1>(r[6]);
  d[10] = pair_at<P - 2>(r[5]);  d[11] = pair_at<P - 3>(r[4]);
  d[12] = pair_at<P - 3>(r[3]);  d[13] = pair_at<P - 3>(r[2]);
  d[14] = pair_at<P - 2>(r[1]);  d[15] = pair_at<P - 1>(r[0]);
}

// MAX_OF_MINS: max over the 16 circular 9-arcs of the min over the arc;
// otherwise min over arcs of the max. Per 16-bit lane, 40 DPX instructions.
template <bool MAX_OF_MINS>
__device__ __forceinline__ uint32_t arc_score(const uint32_t (&d)[16]) {
  auto in3 = [](uint32_t a, uint32_t b, uint32_t c) {
    return MAX_OF_MINS ? __vimin3_u16x2(a, b, c) : __vimax3_u16x2(a, b, c);
  };
  auto out3 = [](uint32_t a, uint32_t b, uint32_t c) {
    return MAX_OF_MINS ? __vimax3_u16x2(a, b, c) : __vimin3_u16x2(a, b, c);
  };
  uint32_t a3[16], a9[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) a3[k] = in3(d[k], d[(k + 1) & 15], d[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) a9[k] = in3(a3[k], a3[(k + 3) & 15], a3[(k + 6) & 15]);
  uint32_t acc = out3(a9[0], a9[1], a9[2]);
#pragma unroll
  for (int k = 3; k < 15; k += 2) acc = out3(acc, a9[k], a9[k + 1]);
  return out3(acc, a9[15], a9[15]);
}

// FAST score of pixels (c + P, c + P + 1): max(bright - c, c - dark, 0)
template <int P>
__device__ __forceinline__ uint32_t fast_pair(const uint32_t (&r)[7][6]) {
  uint32_t d[16];
  ring16<P>(r, d);
  const uint32_t ctr = pair_at<P>(r[3]);
  const uint32_t bright = arc_score<true>(d);
  const uint32_t dark = arc_score<false>(d);
  return __vimax3_u16x2(bright + BIAS - ctr, ctr + BIAS - dark, BIAS) - BIAS;
}

// 0xFFFF in each lane whose pixel (gy, gx + lane) lies in the 3-px interior
__device__ __forceinline__ uint32_t interior(int gy, int gx, int h, int w) {
  const bool row = gy >= BORDER && gy < h - BORDER;
  const bool lo = row && gx >= BORDER && gx < w - BORDER;
  const bool hi = row && gx + 1 >= BORDER && gx + 1 < w - BORDER;
  return (lo ? 0x0000FFFFu : 0u) | (hi ? 0xFFFF0000u : 0u);
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(s));
  return r;
}

// NMS of the pair at D of the middle score row: keep s where it is above
// the earlier neighbours and at least the later ones
template <int D>
__device__ __forceinline__ uint32_t nms_pair(const uint32_t (&up)[6],
                                             const uint32_t (&mid)[6],
                                             const uint32_t (&dn)[6]) {
  const uint32_t s = pair_at<D>(mid);
  const uint32_t before = __vimax3_u16x2(
      __vimax3_u16x2(pair_at<D - 1>(up), pair_at<D>(up), pair_at<D + 1>(up)),
      pair_at<D - 1>(mid), pair_at<D - 1>(mid));
  const uint32_t t = __vimax3_u16x2(
      before + 0x00010001u,
      __vimax3_u16x2(pair_at<D + 1>(mid), pair_at<D - 1>(dn), pair_at<D>(dn)),
      pair_at<D + 1>(dn));
  // s - t + 256 lies in [0, 511]: bit 8 is s >= t; shifted to bits 15 and
  // 31, the sign-replicating byte selectors 9 and B spread it over a lane
  return s & prmt((s + BIAS - t) << 7, 0u, 0xBB99u);
}

__device__ __forceinline__ float lane_lo(uint32_t p) {
  return __int_as_float(__byte_perm(p, 0x4B000000u, 0x7410)) - 8388608.0f;
}
__device__ __forceinline__ float lane_hi(uint32_t p) {
  return __int_as_float(__byte_perm(p, 0x4B000000u, 0x7432)) - 8388608.0f;
}

// pixels gx .. gx + 3 of one map from two lane pairs: one float4 where the
// address is 16-byte aligned, else up to 4 scalar stores
__device__ __forceinline__ void store4(float* out, size_t o, int gx, int w,
                                       uint32_t a, uint32_t b) {
  const float4 v = make_float4(lane_lo(a), lane_hi(a), lane_lo(b), lane_hi(b));
  float* p = out + o;
  if (gx + 3 < w && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    p[0] = v.x;
    if (gx + 1 < w) p[1] = v.y;
    if (gx + 2 < w) p[2] = v.z;
    if (gx + 3 < w) p[3] = v.w;
  }
}

__global__ void __launch_bounds__(U8_THREADS, 4) perception_kernel_u8(
    const uint8_t* __restrict__ img, float* __restrict__ nms,
    float* __restrict__ raw, float* __restrict__ smooth, int h, int w) {
  // two pixels per word: s_img[r][k] = pixels (x0 - 8 + 2k, +1) of row
  // y0 - 4 + r; s_score[r][k] = scores of (x0 - 4 + 2k, +1) in row
  // y0 - 1 + r; s_hsum[r][k] = horizontal 9-sums of (x0 + 2k, +1) in the
  // staged row r
  __shared__ __align__(16) uint32_t s_img[U8_SH][U8_SW];
  __shared__ __align__(16) uint32_t s_score[SC_H][SC_W];
  __shared__ __align__(16) uint32_t s_hsum[U8_SH][U8_TW / 2];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * U8_TW;
  const int y0 = blockIdx.y * U8_TH;
  const uint8_t* im = img + (size_t)b * h * w;
  const int tid = threadIdx.x;

  for (int r = tid >> 5; r < U8_SH; r += U8_THREADS / 32) {
    const int gy = y0 - U8_HY + r;
    const bool row_in = gy >= 0 && gy < h;
    const uint8_t* src = im + (size_t)(row_in ? gy : 0) * w;
    for (int k = tid & 31; k < U8_SW; k += 32) {
      const int gx = x0 - U8_HX + 2 * k;
      const uint32_t p0 = row_in && gx >= 0 && gx < w ? __ldg(src + gx) : 0u;
      const uint32_t p1 = row_in && gx + 1 >= 0 && gx + 1 < w ? __ldg(src + gx + 1) : 0u;
      s_img[r][k] = p0 | (p1 << 16);
    }
  }
  __syncthreads();

  // FAST score on the tile plus a 1-px ring, in groups of 4 columns
  for (int i = tid; i < SC_H * SC_GROUPS; i += U8_THREADS) {
    const int ri = i / SC_GROUPS, gi = i - ri * SC_GROUPS;
    uint32_t rows[7][6];
#pragma unroll
    for (int dy = 0; dy < 7; ++dy) load6(&s_img[ri + dy][2 * gi], rows[dy]);
    uint32_t sa = fast_pair<0>(rows), sb = fast_pair<2>(rows);
    const int gy = y0 - 1 + ri, gx = x0 - 4 + 4 * gi;
    if (!(gy >= BORDER && gy < h - BORDER && gx >= BORDER && gx + 3 < w - BORDER)) {
      sa &= interior(gy, gx, h, w);
      sb &= interior(gy, gx + 2, h, w);
    }
    *reinterpret_cast<uint2*>(&s_score[ri][2 * gi]) = make_uint2(sa, sb);
  }

  // box sum, horizontal pass over every staged row
  for (int i = tid; i < U8_SH * U8_GROUPS; i += U8_THREADS) {
    const int r = i / U8_GROUPS, g = i - r * U8_GROUPS;
    uint32_t px[6];
    load6(&s_img[r][2 * g + 2], px);
    const uint32_t ha = pair_at<-4>(px) + pair_at<-3>(px) + pair_at<-2>(px) +
                        pair_at<-1>(px) + pair_at<0>(px) + pair_at<1>(px) +
                        pair_at<2>(px) + pair_at<3>(px) + pair_at<4>(px);
    const uint32_t hb = ha + pair_at<5>(px) + pair_at<6>(px) -
                        pair_at<-4>(px) - pair_at<-3>(px);
    *reinterpret_cast<uint2*>(&s_hsum[r][2 * g]) = make_uint2(ha, hb);
  }
  __syncthreads();

  // NMS, the vertical box pass and the stores: one group of 4 columns, two
  // adjacent rows per thread
  const int g = tid % U8_GROUPS;
  const int r0 = 2 * (tid / U8_GROUPS);
  const int gx = x0 + 4 * g;
  if (gx >= w) return;
  uint32_t va = 0u, vb = 0u;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const uint2 hs = *reinterpret_cast<const uint2*>(&s_hsum[r0 + k][2 * g]);
    va += hs.x;
    vb += hs.y;
  }
  uint32_t up[6], mid[6], dn[6];
  load6(&s_score[r0][2 * g], up);
  load6(&s_score[r0 + 1][2 * g], mid);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = r0 + j, gy = y0 + r;
    if (gy >= h) break;
    if (j == 1) {
      const uint2 add = *reinterpret_cast<const uint2*>(&s_hsum[r + 8][2 * g]);
      const uint2 sub = *reinterpret_cast<const uint2*>(&s_hsum[r - 1][2 * g]);
      va = va + add.x - sub.x;
      vb = vb + add.y - sub.y;
#pragma unroll
      for (int k = 0; k < 6; ++k) { up[k] = mid[k]; mid[k] = dn[k]; }
    }
    load6(&s_score[r + 2][2 * g], dn);
    const size_t o = ((size_t)b * h + gy) * w + gx;
    store4(raw, o, gx, w, pair_at<0>(mid), pair_at<2>(mid));
    store4(nms, o, gx, w, nms_pair<0>(up, mid, dn), nms_pair<2>(up, mid, dn));
    store4(smooth, o, gx, w, va, vb);
  }
}

// ---------------------------------------------------------------- float

constexpr int TILE_W = 32;
constexpr int TILE_H = 16;
constexpr int HALO = 5;                      // ring/box 4 + NMS 1
constexpr int SMEM_W = TILE_W + 2 * HALO;    // 42
constexpr int SMEM_H = TILE_H + 2 * HALO;    // 26
constexpr int SCORE_W = TILE_W + 2;          // score on tile + 1-px ring
constexpr int SCORE_H = TILE_H + 2;

// FAST-9/16 Bresenham ring (dx, dy), clockwise: lvt_tpu/ops/detect.py
__constant__ int RING_DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int RING_DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

// max over the 16 circular 9-arcs of (min over the arc) — log-step
// windows 2 -> 4 -> 8 -> 9 as in the JAX kernel; with the roles of min and
// max swapped it gives min over arcs of (max over the arc).
template <bool BRIGHT>
__device__ __forceinline__ float arc_score_f32(const float (&d)[16]) {
  auto in2 = [](float a, float b) { return BRIGHT ? fminf(a, b) : fmaxf(a, b); };
  auto out2 = [](float a, float b) { return BRIGHT ? fmaxf(a, b) : fminf(a, b); };
  float b2[16], b4[16], b8[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) b2[k] = in2(d[k], d[(k + 1) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) b4[k] = in2(b2[k], b2[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) b8[k] = in2(b4[k], b4[(k + 4) & 15]);
  float acc = in2(b8[0], d[8]);
#pragma unroll
  for (int k = 1; k < 16; ++k) acc = out2(acc, in2(b8[k], d[(k + 8) & 15]));
  return acc;
}

__global__ void __launch_bounds__(256) perception_kernel_f32(
    const float* __restrict__ img, float* __restrict__ nms,
    float* __restrict__ raw, float* __restrict__ smooth, int h, int w) {
  __shared__ float s_img[SMEM_H][SMEM_W];
  __shared__ float s_rsum[TILE_H][SMEM_W];   // vertical 9-sums of the tile rows
  __shared__ float s_score[SCORE_H][SCORE_W];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const float* im = img + (size_t)b * h * w;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  for (int i = tid; i < SMEM_H * SMEM_W; i += nthreads) {
    const int r = i / SMEM_W, c = i % SMEM_W;
    const int gy = y0 - HALO + r, gx = x0 - HALO + c;
    s_img[r][c] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                      ? im[(size_t)gy * w + gx] : 0.0f;
  }
  __syncthreads();

  // box sum, row pass: same order as the JAX kernel (+d, then -d)
  for (int i = tid; i < TILE_H * SMEM_W; i += nthreads) {
    const int r = i / SMEM_W, c = i % SMEM_W;
    const int rr = r + HALO;
    float s = s_img[rr][c];
#pragma unroll
    for (int d = 1; d <= 4; ++d) {
      s = s + s_img[rr + d][c];
      s = s + s_img[rr - d][c];
    }
    s_rsum[r][c] = s;
  }

  // FAST score on the tile plus a 1-px ring, zero outside the 3-px
  // interior of the true image (so NMS sees what detect.nms3x3 sees)
  for (int i = tid; i < SCORE_H * SCORE_W; i += nthreads) {
    const int r = i / SCORE_W, c = i % SCORE_W;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    float sc = 0.0f;
    if (gy >= BORDER && gy < h - BORDER && gx >= BORDER && gx < w - BORDER) {
      const int sr = r + HALO - 1, scol = c + HALO - 1;
      const float ctr = s_img[sr][scol];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = s_img[sr + RING_DY[k]][scol + RING_DX[k]] - ctr;
      const float bright = arc_score_f32<true>(d);
      const float dark = -arc_score_f32<false>(d);
      sc = fmaxf(fmaxf(bright, dark), 0.0f);
    }
    s_score[r][c] = sc;
  }
  __syncthreads();

  for (int i = tid; i < TILE_H * TILE_W; i += nthreads) {
    const int r = i / TILE_W, c = i % TILE_W;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= h || gx >= w) continue;
    const int sr = r + 1, scol = c + 1;
    const float s = s_score[sr][scol];
    // plateau-collapsing NMS: strictly above the earlier neighbours
    // (above / left), at least the later ones (right / below)
    const float before = fmaxf(fmaxf(s_score[sr - 1][scol - 1], s_score[sr - 1][scol]),
                               fmaxf(s_score[sr - 1][scol + 1], s_score[sr][scol - 1]));
    const float after = fmaxf(fmaxf(s_score[sr][scol + 1], s_score[sr + 1][scol - 1]),
                              fmaxf(s_score[sr + 1][scol], s_score[sr + 1][scol + 1]));
    const int cc = c + HALO;
    float sm = s_rsum[r][cc];
#pragma unroll
    for (int d = 1; d <= 4; ++d) {
      sm = sm + s_rsum[r][cc + d];
      sm = sm + s_rsum[r][cc - d];
    }
    const size_t o = ((size_t)b * h + gy) * w + gx;
    raw[o] = s;
    nms[o] = (s > before && s >= after) ? s : 0.0f;
    smooth[o] = sm;
  }
}

}  // namespace

extern "C" int lvt_perception(const void* img, int is_uint8, float* nms,
                              float* raw, float* smooth, int batch, int h,
                              int w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_uint8) {
    const dim3 grid((w + U8_TW - 1) / U8_TW, (h + U8_TH - 1) / U8_TH, batch);
    perception_kernel_u8<<<grid, U8_THREADS, 0, s>>>(
        static_cast<const uint8_t*>(img), nms, raw, smooth, h, w);
  } else {
    const dim3 grid((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H, batch);
    perception_kernel_f32<<<grid, dim3(32, 8), 0, s>>>(
        static_cast<const float*>(img), nms, raw, smooth, h, w);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
