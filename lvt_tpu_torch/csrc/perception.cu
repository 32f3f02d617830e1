// Kernel A for Hopper: 9x9 box sum, FAST-9/16 max-threshold score and
// plateau-collapsing 3x3 NMS, fused in one pass over the image.
//
// Replaces lvt_tpu/ops/perception_pallas.py::_score_smooth_kernel (reached
// through perception_patch_maps_batched). Same semantics, not the same
// blocking: the TPU kernel rolls whole VMEM slabs; here one block owns a
// 32x16 output tile, stages the image tile plus a 5-px halo (4 for the box
// and the FAST ring, 1 for NMS) in shared memory with zero padding (the
// TPU kernel's jnp.pad), computes the score on the tile plus a 1-px ring,
// then one thread per output pixel applies NMS and the column pass of the
// box sum.
//
// uint8 frames compute in int32: every value is an exact integer (box sums
// <= 81*255 = 20655, ring differences in [-255, 255]), so all three outputs
// are bit-exact with the JAX kernel. float frames compute in f32 with the
// JAX kernel's summation order (rows +d then -d, then columns +d then -d),
// and no product is formed, so no FMA contraction can change a bit.
//
// What bounds it on the card: device-memory traffic — 1 byte in and 12
// bytes out per pixel for uint8 frames; the ~140 integer min/max per pixel
// of the FAST arc test run from registers and shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 16;
constexpr int HALO = 5;                      // ring/box 4 + NMS 1
constexpr int SMEM_W = TILE_W + 2 * HALO;    // 42
constexpr int SMEM_H = TILE_H + 2 * HALO;    // 26
constexpr int SCORE_W = TILE_W + 2;          // score on tile + 1-px ring
constexpr int SCORE_H = TILE_H + 2;
constexpr int BORDER = 3;                    // FAST ring radius

// FAST-9/16 Bresenham ring (dx, dy), clockwise: lvt_tpu/ops/detect.py
__constant__ int RING_DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int RING_DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__device__ __forceinline__ int vmin(int a, int b) { return min(a, b); }
__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }

// max over the 16 circular 9-arcs of (min over the arc) — log-step
// windows 2 -> 4 -> 8 -> 9 as in the JAX kernel; with the roles of min and
// max swapped it gives min over arcs of (max over the arc).
template <typename T, bool BRIGHT>
__device__ __forceinline__ T arc_score(const T (&d)[16]) {
  T b2[16], b4[16], b8[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) b2[k] = BRIGHT ? vmin(d[k], d[(k + 1) & 15]) : vmax(d[k], d[(k + 1) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) b4[k] = BRIGHT ? vmin(b2[k], b2[(k + 2) & 15]) : vmax(b2[k], b2[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) b8[k] = BRIGHT ? vmin(b4[k], b4[(k + 4) & 15]) : vmax(b4[k], b4[(k + 4) & 15]);
  T acc = BRIGHT ? vmin(b8[0], d[8]) : vmax(b8[0], d[8]);
#pragma unroll
  for (int k = 1; k < 16; ++k) {
    T a9 = BRIGHT ? vmin(b8[k], d[(k + 8) & 15]) : vmax(b8[k], d[(k + 8) & 15]);
    acc = BRIGHT ? vmax(acc, a9) : vmin(acc, a9);
  }
  return acc;
}

template <typename TIn, typename T>
__global__ void __launch_bounds__(256) perception_kernel(
    const TIn* __restrict__ img, float* __restrict__ nms,
    float* __restrict__ raw, float* __restrict__ smooth, int h, int w) {
  __shared__ T s_img[SMEM_H][SMEM_W];
  __shared__ T s_rsum[TILE_H][SMEM_W];   // vertical 9-sums of the tile rows
  __shared__ T s_score[SCORE_H][SCORE_W];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const TIn* im = img + (size_t)b * h * w;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  for (int i = tid; i < SMEM_H * SMEM_W; i += nthreads) {
    const int r = i / SMEM_W, c = i % SMEM_W;
    const int gy = y0 - HALO + r, gx = x0 - HALO + c;
    T v = T(0);
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) v = static_cast<T>(im[(size_t)gy * w + gx]);
    s_img[r][c] = v;
  }
  __syncthreads();

  // box sum, row pass: same order as the JAX kernel (+d, then -d)
  for (int i = tid; i < TILE_H * SMEM_W; i += nthreads) {
    const int r = i / SMEM_W, c = i % SMEM_W;
    const int rr = r + HALO;
    T s = s_img[rr][c];
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
    T sc = T(0);
    if (gy >= BORDER && gy < h - BORDER && gx >= BORDER && gx < w - BORDER) {
      const int sr = r + HALO - 1, scol = c + HALO - 1;
      const T ctr = s_img[sr][scol];
      T d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = s_img[sr + RING_DY[k]][scol + RING_DX[k]] - ctr;
      const T bright = arc_score<T, true>(d);
      const T dark = -arc_score<T, false>(d);
      sc = vmax(vmax(bright, dark), T(0));
    }
    s_score[r][c] = sc;
  }
  __syncthreads();

  for (int i = tid; i < TILE_H * TILE_W; i += nthreads) {
    const int r = i / TILE_W, c = i % TILE_W;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= h || gx >= w) continue;
    const int sr = r + 1, scol = c + 1;
    const T s = s_score[sr][scol];
    // plateau-collapsing NMS: strictly above the earlier neighbours
    // (above / left), at least the later ones (right / below)
    const T before = vmax(vmax(s_score[sr - 1][scol - 1], s_score[sr - 1][scol]),
                          vmax(s_score[sr - 1][scol + 1], s_score[sr][scol - 1]));
    const T after = vmax(vmax(s_score[sr][scol + 1], s_score[sr + 1][scol - 1]),
                         vmax(s_score[sr + 1][scol], s_score[sr + 1][scol + 1]));
    const int cc = c + HALO;
    T sm = s_rsum[r][cc];
#pragma unroll
    for (int d = 1; d <= 4; ++d) {
      sm = sm + s_rsum[r][cc + d];
      sm = sm + s_rsum[r][cc - d];
    }
    const size_t o = ((size_t)b * h + gy) * w + gx;
    raw[o] = static_cast<float>(s);
    nms[o] = (s > before && s >= after) ? static_cast<float>(s) : 0.0f;
    smooth[o] = static_cast<float>(sm);
  }
}

}  // namespace

extern "C" int lvt_perception(const void* img, int is_uint8, float* nms,
                              float* raw, float* smooth, int batch, int h,
                              int w, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_uint8) {
    perception_kernel<uint8_t, int><<<grid, block, 0, s>>>(
        static_cast<const uint8_t*>(img), nms, raw, smooth, h, w);
  } else {
    perception_kernel<float, float><<<grid, block, 0, s>>>(
        static_cast<const float*>(img), nms, raw, smooth, h, w);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
