// Kernel B for Hopper: dense BRIEF-256 bit planes of the smoothed image.
//
// Replaces lvt_tpu/ops/perception_pallas.py::_brief_kernel (reached through
// perception_maps_batched). For every pixel p of smooth [B, H, W] f32, the
// 64 pool samples s_k = smooth[p + (dy_k, dx_k)] (offsets within +-15 px,
// zero outside the image) are compared pairwise: bit i of word w is
// s[pi] < s[pj] for pair 32w + i. The words go to planes [B, 8, H, W] as
// int32 holding the same bits as the JAX kernel's uint32.
//
// Same semantics, not the same blocking: the TPU kernel rolls whole VMEM
// slabs 64 times. Here one block owns a 64x32 output tile and stages the
// columns and rows the pattern reaches around it (dx in [-12, 15] plus the
// pair's second pixel, |dy| <= 15: 92x62 floats) in shared memory with
// cp.async, zero-filled outside the image, twice: once as it is and once
// shifted by one column. A thread computes two horizontally adjacent
// pixels, so sample k of both is one 8-byte shared load: from the first
// copy where dx_k is even, from the shifted one where it is odd. The
// pattern is compiled in and run in the order of LVT_BRIEF_SCHEDULE
// (brief_pattern.cuh): each comparison follows the load of the later of
// its samples, so at most 29 of the 64 sample pairs are live and the
// register budget of __launch_bounds__(256, 2) holds without spills (107
// registers: two blocks, 16 warps per SM; a budget for three spilled).
// Only comparisons: the planes are bit-exact with the plain version for
// any input (ties, -0.0, infinities, NaN).
//
// What bounds it on the card: the 256 comparisons and bit inserts per
// pixel (~0.24 G per KITTI stereo pair) against 4 bytes in and 32 bytes
// out; each word plane is written coalesced along x, 8 bytes per thread
// where the row's address allows it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "brief_pattern.cuh"

namespace {

constexpr int TILE_W = 64;                   // output columns (32 pairs)
constexpr int TILE_H = 32;                   // output rows
constexpr int LEFT = 12;                     // min pattern dx = -12
constexpr int RIGHT = 16;                    // max dx = 15, plus the pair's 2nd pixel
constexpr int HALO_Y = 15;                   // max |dy|
constexpr int SMEM_W = LEFT + TILE_W + RIGHT;    // 92 (even: rows stay 8-byte aligned)
constexpr int SMEM_H = TILE_H + 2 * HALO_Y;      // 62
constexpr int THREADS_X = TILE_W / 2;            // 32: one warp per tile row
constexpr int THREADS_Y = 8;

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool inside) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 writes zeros without reading the source
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(inside ? 4 : 0));
}

__global__ void __launch_bounds__(THREADS_X * THREADS_Y, 2) brief_kernel(
    const float* __restrict__ smooth, int32_t* __restrict__ planes, int h,
    int w) {
  // s_even[r][c] = smooth(y0 - HALO_Y + r, x0 - LEFT + c); s_odd one column on
  __shared__ __align__(16) float s_even[SMEM_H][SMEM_W];
  __shared__ __align__(16) float s_odd[SMEM_H][SMEM_W];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const float* sm = smooth + (size_t)b * h * w;
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int r = ty; r < SMEM_H; r += THREADS_Y) {
    const int gy = y0 - HALO_Y + r;
    const bool row_in = gy >= 0 && gy < h;
    const float* src = sm + (size_t)(row_in ? gy : 0) * w;
    for (int c = tx; c < SMEM_W; c += THREADS_X) {
      const int gx = x0 - LEFT + c;
      const bool in0 = row_in && gx >= 0 && gx < w;
      const bool in1 = row_in && gx + 1 >= 0 && gx + 1 < w;
      cp_async4(&s_even[r][c], in0 ? src + gx : sm, in0);
      cp_async4(&s_odd[r][c], in1 ? src + gx + 1 : sm, in1);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int cx = 2 * tx;                     // the pair's first column in the tile
  const int gx = x0 + cx;
  if (gx >= w) return;
  const size_t plane = (size_t)h * w;
  int32_t* out_b = planes + (size_t)b * 8 * plane;

#pragma unroll 1
  for (int r = ty; r < TILE_H; r += THREADS_Y) {
    const int gy = y0 + r;
    if (gy >= h) break;
    // sample (dx, dy) of pixels (cx, cx + 1): columns cx + dx + LEFT and
    // the next; an odd dx reads the shifted copy one column to the left
    const float* even = &s_even[r + HALO_Y][cx + LEFT];
    const float* odd = &s_odd[r + HALO_Y][cx + LEFT - 1];
    float2 v[64];
    uint32_t lo[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    uint32_t hi[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#define LVT_LOAD(k, dx, dy)                                                \
  v[k] = *reinterpret_cast<const float2*>(((dx) & 1 ? odd : even) +         \
                                          (dy) * SMEM_W + (dx));
// compiles to a compare and a predicated add per bit (FSETP, VIADD);
// `|= (a < b) << k` compiles to a compare, a select and half an add
#define LVT_BIT(k, i, j)                                                   \
  if (v[i].x < v[j].x) lo[(k) >> 5] |= 1u << ((k) & 31);                   \
  if (v[i].y < v[j].y) hi[(k) >> 5] |= 1u << ((k) & 31);
    LVT_BRIEF_SCHEDULE(LVT_LOAD, LVT_BIT)
#undef LVT_BIT
#undef LVT_LOAD

    int32_t* out = out_b + (size_t)gy * w + gx;
    const bool pair = gx + 1 < w;
    const bool aligned = (reinterpret_cast<uintptr_t>(out) & 7) == 0 &&
                         (plane & 1) == 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      int32_t* o = out + k * plane;
      if (pair && aligned) {
        *reinterpret_cast<int2*>(o) = make_int2(static_cast<int32_t>(lo[k]),
                                                static_cast<int32_t>(hi[k]));
      } else {
        o[0] = static_cast<int32_t>(lo[k]);
        if (pair) o[1] = static_cast<int32_t>(hi[k]);
      }
    }
  }
}

}  // namespace

extern "C" int lvt_brief_planes(const float* smooth, int32_t* planes,
                                int batch, int h, int w, void* stream) {
  const dim3 block(THREADS_X, THREADS_Y);
  const dim3 grid((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H, batch);
  brief_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      smooth, planes, h, w);
  return static_cast<int>(cudaGetLastError());
}
