// Per-keypoint patch extraction for Hopper.
//
// Replaces lvt_tpu/ops/patches_pallas.py::_patch_kernel (reached through
// extract_patches_batched). For each keypoint slot it copies the 32x32
// smooth patch at (y - 15, x - 16) and the 8x8 raw-score patch at
// (y - 3, x - 4); invalid slots come back zero. The TPU kernel's span
// loads, rotates and two lane phases exist only to satisfy Mosaic's
// (8, 128) alignment rules; on Hopper this is a plain gather: one warp per
// keypoint, each lane one column, so every patch row is one coalesced
// 128-byte read and write.
//
// The coordinates are clamped again in the kernel exactly as clamp_coords
// does (idempotent for the pre-clamped coordinates the caller passes), so
// no input can make it read outside the maps.
//
// What bounds it on the card: device-memory traffic — 4.3 KB written per
// keypoint slot (the patch tensor) against 4.3 KB of largely cached reads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PATCH = 32;
constexpr int PATCH_R0 = 15;
constexpr int PATCH_C0 = 16;
constexpr int RAWP = 8;
constexpr int RAWP_R0 = 3;
constexpr int RAWP_C0 = 4;
constexpr int WARPS_PER_BLOCK = 8;

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32) patch_kernel(
    const float* __restrict__ smooth, const float* __restrict__ raw,
    const int* __restrict__ xs, const int* __restrict__ ys,
    const uint8_t* __restrict__ valid, float* __restrict__ patches,
    float* __restrict__ rawp, int batch, int h, int w, int k) {
  const int lane = threadIdx.x & 31;
  const long slot = (long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (slot >= (long)batch * k) return;
  float* po = patches + slot * (PATCH * PATCH);
  float* ro = rawp + slot * (RAWP * RAWP);
  if (!valid[slot]) {
    for (int i = lane; i < PATCH * PATCH; i += 32) po[i] = 0.0f;
    for (int i = lane; i < RAWP * RAWP; i += 32) ro[i] = 0.0f;
    return;
  }
  const long b = slot / k;
  const int x = min(max(xs[slot], PATCH_C0), w - PATCH + PATCH_C0);
  const int y = min(max(ys[slot], PATCH_R0), h - PATCH + PATCH_R0);
  const float* sm = smooth + b * h * w + (size_t)(y - PATCH_R0) * w + (x - PATCH_C0);
#pragma unroll 4
  for (int r = 0; r < PATCH; ++r) po[r * PATCH + lane] = sm[(size_t)r * w + lane];
  const float* rw = raw + b * h * w + (size_t)(y - RAWP_R0) * w + (x - RAWP_C0);
  for (int i = lane; i < RAWP * RAWP; i += 32) ro[i] = rw[(size_t)(i / RAWP) * w + (i % RAWP)];
}

}  // namespace

extern "C" int lvt_extract_patches(const float* smooth, const float* raw,
                                   const int* x, const int* y,
                                   const uint8_t* valid, float* patches,
                                   float* rawp, int batch, int h, int w, int k,
                                   void* stream) {
  const long slots = (long)batch * k;
  const int blocks = static_cast<int>((slots + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  if (blocks > 0) {
    patch_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        smooth, raw, x, y, valid, patches, rawp, batch, h, w, k);
  }
  return static_cast<int>(cudaGetLastError());
}
