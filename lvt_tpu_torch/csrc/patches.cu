// Kernel P for Hopper: BRIEF descriptor and subpixel refinement of each
// keypoint slot, straight from the maps.
//
// Replaces lvt_tpu/ops/patches_pallas.py::_patch_kernel (reached through
// extract_patches_batched) together with its only consumer, the describe
// and refine steps (ops/brief.py::descriptors_from_patches and
// ops/detect.py::subpixel_from_patches). The TPU kernel copies a 32x32
// smooth patch at (y - 15, x - 16) and an 8x8 raw-score patch at
// (y - 3, x - 4) per slot to device memory (13.4 MB at 2 x 1536 slots);
// the describe and refine steps then read back 64 pool samples and 5 raw
// scores of each. Here those 69 values are read from the maps directly and
// the patches never exist.
//
// Per slot, bit-equal with the plain composition for every slot, valid or
// not:
//   * pool sample k is smooth[yc + dy_k, xc + dx_k] (the patch's
//     (15 + dy_k, 16 + dx_k) entry) at the clamped corner (xc, yc), zero
//     for a slot that is not selected (the TPU kernel's zeroed patch);
//   * bit i of word w is s[p_i] < s[p_j] for pair 32w + i (brief.pack_bits);
//   * the descriptor is kept only if the slot is selected and its unclamped
//     corner (x, y) lies BORDER = 20 px inside the image, else it is zero;
//   * the subpixel offsets are ops/detect.py::_parab_offset of the raw
//     scores at (yc, xc -+ 1) and (yc -+ 1, xc), zero for an unselected
//     slot, in the plain version's order with round-to-nearest intrinsics
//     (no FMA contraction, IEEE division), added to the unclamped x and y.
//
// Design: one warp per slot, 8 slots per block. The lanes load the 64 pool
// samples (two each) into the warp's shared memory; lane l then evaluates
// pair 32w + l for w = 0..7 and __ballot_sync packs word w directly. Lane 0
// reads the five raw scores and refines the corner.
//
// What bounds it on the card: ~0.3 KB read and 41 B written per slot,
// about 1 MB in all at 2 x 1536 slots, and 256 comparisons per slot: well
// under a microsecond, so launch latency sets its time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "brief_pattern.cuh"

namespace {

constexpr int PATCH = 32;
constexpr int PATCH_R0 = 15;    // pool offsets lie in [-15, 15]
constexpr int PATCH_C0 = 16;
constexpr int BORDER = 20;      // ops/brief.py BORDER
constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

#define LVT_DX(k, dx, dy) dx,
#define LVT_DY(k, dx, dy) dy,
#define LVT_PAIR(b, i, j) static_cast<uint16_t>((i) | ((j) << 8)),
__device__ const int8_t POOL_DX[64] = {LVT_BRIEF_POOL(LVT_DX)};
__device__ const int8_t POOL_DY[64] = {LVT_BRIEF_POOL(LVT_DY)};
__device__ const uint16_t PAIRS[256] = {LVT_BRIEF_PAIRS(LVT_PAIR)};
#undef LVT_DX
#undef LVT_DY
#undef LVT_PAIR

// ops/detect.py::_parab_offset: 0.5 * (sm - sp) / (sm - 2 s0 + sp), zero
// where |denominator| < 1e-6, clamped to [-0.5, 0.5] (NaN passes, as in
// torch.clamp)
__device__ __forceinline__ float parab_offset(float sm, float s0, float sp) {
  const float denom = __fadd_rn(__fsub_rn(sm, __fmul_rn(2.0f, s0)), sp);
  const bool small = fabsf(denom) < 1e-6f;
  const float off = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(sm, sp)),
                              small ? 1e-6f : denom);
  const float o = small ? 0.0f : off;
  return o < -0.5f ? -0.5f : (o > 0.5f ? 0.5f : o);
}

__global__ void __launch_bounds__(WARPS * 32) describe_refine_kernel(
    const float* __restrict__ smooth, const float* __restrict__ raw,
    const int* __restrict__ xcs, const int* __restrict__ ycs,
    const int* __restrict__ xs, const int* __restrict__ ys,
    const uint8_t* __restrict__ sel, int32_t* __restrict__ desc,
    uint8_t* __restrict__ valid_out, float* __restrict__ kp, int batch,
    int h, int w, int k, int img_h, int img_w) {
  __shared__ float pool[WARPS][64];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long slot = (long)blockIdx.x * WARPS + warp;
  if (slot >= (long)batch * k) return;  // uniform across the warp
  const long b = slot / k;
  const bool on = sel[slot];
  // clamp_coords again, so no input can make it read outside the maps
  const int xc = min(max(xcs[slot], PATCH_C0), w - PATCH + PATCH_C0);
  const int yc = min(max(ycs[slot], PATCH_R0), h - PATCH + PATCH_R0);
  const float* sm = smooth + b * h * w;
#pragma unroll
  for (int s = lane; s < 64; s += 32) {
    const int dx = __ldg(&POOL_DX[s]);
    const int dy = __ldg(&POOL_DY[s]);
    pool[warp][s] = on ? sm[(size_t)(yc + dy) * w + (xc + dx)] : 0.0f;
  }
  __syncwarp();

  const int x = xs[slot];
  const int y = ys[slot];
  const bool valid = on && x >= BORDER && x < img_w - BORDER &&
                     y >= BORDER && y < img_h - BORDER;
  uint32_t mine = 0u;  // lane w keeps word w
#pragma unroll
  for (int wd = 0; wd < 8; ++wd) {
    const int pair = __ldg(&PAIRS[32 * wd + lane]);
    const unsigned word =
        __ballot_sync(FULL, pool[warp][pair & 0xff] < pool[warp][pair >> 8]);
    if (lane == wd) mine = word;
  }
  if (lane < 8) desc[slot * 8 + lane] = valid ? static_cast<int32_t>(mine) : 0;

  if (lane == 0) {
    valid_out[slot] = valid;
    const float* rw = raw + b * h * w + (size_t)yc * w + xc;
    const float s0 = on ? rw[0] : 0.0f;
    const float sxm = on ? rw[-1] : 0.0f;
    const float sxp = on ? rw[1] : 0.0f;
    const float sym = on ? rw[-w] : 0.0f;
    const float syp = on ? rw[w] : 0.0f;
    kp[2 * slot] = __fadd_rn(static_cast<float>(x), parab_offset(sxm, s0, sxp));
    kp[2 * slot + 1] =
        __fadd_rn(static_cast<float>(y), parab_offset(sym, s0, syp));
  }
}

}  // namespace

extern "C" int lvt_describe_refine(const float* smooth, const float* raw,
                                   const int* xc, const int* yc, const int* x,
                                   const int* y, const uint8_t* sel,
                                   int32_t* desc, uint8_t* valid, float* kp,
                                   int batch, int h, int w, int k, int img_h,
                                   int img_w, void* stream) {
  const long slots = (long)batch * k;
  const int blocks = static_cast<int>((slots + WARPS - 1) / WARPS);
  if (blocks > 0) {
    describe_refine_kernel<<<blocks, WARPS * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        smooth, raw, xc, yc, x, y, sel, desc, valid, kp, batch, h, w, k,
        img_h, img_w);
  }
  return static_cast<int>(cudaGetLastError());
}
