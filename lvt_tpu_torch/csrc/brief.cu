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
// slabs 64 times. Here one block owns a 32x16 output tile and stages the
// tile plus a 16-px halo (48x64 floats, 12 KB) in shared memory with zero
// padding; one thread per output pixel reads its 64 samples into registers
// and evaluates the 256 comparisons. The pattern is compiled in (the
// X-macro tables of brief_pattern.cuh), so every
// sample is a shared-memory load at an immediate offset and every
// comparison names two registers. Only comparisons, no arithmetic: the
// planes are bit-exact with the plain version for any input.
//
// What bounds it on the card: 256 compare-and-pack steps per pixel from
// registers (~0.24 G per KITTI stereo pair) against 4 bytes in and 32
// bytes out; each word plane is written coalesced along x.

#include <cuda_runtime.h>
#include <stdint.h>

#include "brief_pattern.cuh"

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 16;
constexpr int HALO = 16;                     // max |pattern offset| = 15
constexpr int SMEM_W = TILE_W + 2 * HALO;    // 64
constexpr int SMEM_H = TILE_H + 2 * HALO;    // 48

__global__ void __launch_bounds__(TILE_W * TILE_H) brief_kernel(
    const float* __restrict__ smooth, int32_t* __restrict__ planes, int h,
    int w) {
  __shared__ float s_tile[SMEM_H][SMEM_W];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const float* sm = smooth + (size_t)b * h * w;
  const int tid = threadIdx.y * TILE_W + threadIdx.x;

  for (int i = tid; i < SMEM_H * SMEM_W; i += TILE_W * TILE_H) {
    const int r = i / SMEM_W, c = i % SMEM_W;
    const int gy = y0 - HALO + r, gx = x0 - HALO + c;
    s_tile[r][c] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                       ? sm[(size_t)gy * w + gx] : 0.0f;
  }
  __syncthreads();

  const int gx = x0 + threadIdx.x, gy = y0 + threadIdx.y;
  if (gx >= w || gy >= h) return;
  const int cy = threadIdx.y + HALO, cx = threadIdx.x + HALO;

  float v[64];
#define LVT_LOAD(k, dx, dy) v[k] = s_tile[cy + (dy)][cx + (dx)];
  LVT_BRIEF_POOL(LVT_LOAD)
#undef LVT_LOAD

  uint32_t word[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#define LVT_BIT(k, i, j) \
  word[(k) >> 5] |= static_cast<uint32_t>(v[i] < v[j]) << ((k) & 31);
  LVT_BRIEF_PAIRS(LVT_BIT)
#undef LVT_BIT

  const size_t plane = (size_t)h * w;
  int32_t* out = planes + (size_t)b * 8 * plane + (size_t)gy * w + gx;
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k * plane] = static_cast<int32_t>(word[k]);
}

}  // namespace

extern "C" int lvt_brief_planes(const float* smooth, int32_t* planes,
                                int batch, int h, int w, void* stream) {
  const dim3 block(TILE_W, TILE_H);
  const dim3 grid((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H, batch);
  brief_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      smooth, planes, h, w);
  return static_cast<int>(cudaGetLastError());
}
