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
// X-macro tables below, generated from lvt_tpu_torch/ops/brief.py's
// sample_pool() and pair_indices(); a CPU test holds them equal), so every
// sample is a shared-memory load at an immediate offset and every
// comparison names two registers. Only comparisons, no arithmetic: the
// planes are bit-exact with the plain version for any input.
//
// What bounds it on the card: 256 compare-and-pack steps per pixel from
// registers (~0.24 G per KITTI stereo pair) against 4 bytes in and 32
// bytes out; each word plane is written coalesced along x.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 16;
constexpr int HALO = 16;                     // max |pattern offset| = 15
constexpr int SMEM_W = TILE_W + 2 * HALO;    // 64
constexpr int SMEM_H = TILE_H + 2 * HALO;    // 48

// X(sample, dx, dy): the 64 pool offsets (lvt_tpu/ops/brief.py sample_pool)
#define LVT_BRIEF_POOL(X) \
  X(0, -8, -3) X(1, -5, -4) X(2, 3, 3) X(3, -5, -10) X(4, 5, 6) X(5, 3, -11) \
  X(6, 0, 4) X(7, 7, -1) X(8, -4, 5) X(9, 2, -6) X(10, 9, -1) X(11, 15, -7) \
  X(12, 0, -2) X(13, 1, -2) X(14, -3, -15) X(15, 8, -1) X(16, 7, 5) X(17, -8, 4) \
  X(18, 4, 8) X(19, -7, -8) X(20, -10, 9) X(21, 1, 0) X(22, -9, -8) X(23, 6, -11) \
  X(24, 3, -9) X(25, 1, -10) X(26, -2, -6) X(27, 5, 2) X(28, -2, -4) X(29, -3, 10) \
  X(30, 3, -5) X(31, -5, 0) X(32, 7, 7) X(33, 6, 6) X(34, -4, 7) X(35, 0, 5) \
  X(36, -11, -10) X(37, -6, -5) X(38, -10, -2) X(39, 2, -4) X(40, -5, 3) X(41, -2, 8) \
  X(42, 4, 1) X(43, -8, -2) X(44, -10, -4) X(45, -8, 8) X(46, -10, 3) X(47, -4, 3) \
  X(48, 10, -3) X(49, 9, -10) X(50, -5, 7) X(51, 15, -9) X(52, 11, -8) X(53, 2, 7) \
  X(54, 6, -2) X(55, 8, -8) X(56, 6, -3) X(57, 0, 8) X(58, 14, -3) X(59, 4, 15) \
  X(60, -2, 6) X(61, -12, 8) X(62, 0, 2) X(63, -11, -1)

// X(bit, i, j): bit = s[i] < s[j] (lvt_tpu/ops/brief.py pair_indices)
#define LVT_BRIEF_PAIRS(X) \
  X(0, 49, 56) X(1, 59, 54) X(2, 7, 40) X(3, 38, 57) X(4, 33, 13) X(5, 1, 24) \
  X(6, 25, 0) X(7, 47, 3) X(8, 12, 37) X(9, 3, 53) X(10, 57, 41) X(11, 12, 25) \
  X(12, 3, 28) X(13, 56, 27) X(14, 8, 27) X(15, 40, 59) X(16, 1, 3) X(17, 24, 0) \
  X(18, 33, 45) X(19, 33, 8) X(20, 41, 59) X(21, 23, 8) X(22, 2, 37) X(23, 9, 36) \
  X(24, 17, 61) X(25, 63, 32) X(26, 9, 39) X(27, 54, 11) X(28, 6, 40) X(29, 11, 56) \
  X(30, 5, 52) X(31, 34, 15) X(32, 45, 34) X(33, 45, 59) X(34, 42, 23) X(35, 45, 53) \
  X(36, 3, 18) X(37, 27, 42) X(38, 52, 39) X(39, 61, 30) X(40, 21, 29) X(41, 62, 15) \
  X(42, 24, 9) X(43, 58, 9) X(44, 50, 12) X(45, 4, 12) X(46, 51, 35) X(47, 41, 56) \
  X(48, 27, 4) X(49, 13, 10) X(50, 16, 31) X(51, 32, 15) X(52, 42, 30) X(53, 42, 59) \
  X(54, 57, 1) X(55, 1, 41) X(56, 30, 0) X(57, 2, 49) X(58, 44, 13) X(59, 32, 59) \
  X(60, 14, 23) X(61, 0, 34) X(62, 23, 28) X(63, 58, 0) X(64, 47, 32) X(65, 56, 35) \
  X(66, 14, 0) X(67, 62, 4) X(68, 7, 49) X(69, 56, 6) X(70, 21, 25) X(71, 26, 11) \
  X(72, 46, 59) X(73, 52, 36) X(74, 33, 51) X(75, 6, 31) X(76, 19, 17) X(77, 39, 44) \
  X(78, 49, 20) X(79, 15, 19) X(80, 31, 20) X(81, 43, 4) X(82, 60, 44) X(83, 47, 23) \
  X(84, 42, 56) X(85, 45, 52) X(86, 37, 38) X(87, 2, 0) X(88, 55, 45) X(89, 54, 28) \
  X(90, 37, 59) X(91, 20, 57) X(92, 49, 47) X(93, 53, 0) X(94, 55, 30) X(95, 56, 17) \
  X(96, 62, 43) X(97, 35, 33) X(98, 30, 31) X(99, 23, 54) X(100, 59, 49) X(101, 3, 23) \
  X(102, 52, 26) X(103, 62, 40) X(104, 9, 5) X(105, 30, 33) X(106, 3, 19) X(107, 27, 25) \
  X(108, 18, 57) X(109, 22, 34) X(110, 37, 54) X(111, 23, 39) X(112, 16, 53) X(113, 12, 27) \
  X(114, 8, 53) X(115, 33, 11) X(116, 7, 44) X(117, 26, 57) X(118, 33, 32) X(119, 21, 57) \
  X(120, 63, 14) X(121, 61, 49) X(122, 7, 36) X(123, 12, 28) X(124, 62, 6) X(125, 44, 56) \
  X(126, 43, 49) X(127, 28, 14) X(128, 6, 16) X(129, 50, 5) X(130, 50, 63) X(131, 21, 49) \
  X(132, 54, 41) X(133, 26, 8) X(134, 32, 56) X(135, 47, 45) X(136, 62, 31) X(137, 41, 34) \
  X(138, 55, 21) X(139, 39, 29) X(140, 19, 7) X(141, 16, 1) X(142, 13, 36) X(143, 37, 58) \
  X(144, 8, 49) X(145, 44, 16) X(146, 39, 49) X(147, 28, 37) X(148, 17, 38) X(149, 36, 2) \
  X(150, 1, 56) X(151, 63, 9) X(152, 53, 37) X(153, 23, 21) X(154, 52, 18) X(155, 56, 25) \
  X(156, 9, 53) X(157, 59, 7) X(158, 50, 18) X(159, 29, 40) X(160, 10, 29) X(161, 30, 5) \
  X(162, 57, 13) X(163, 53, 51) X(164, 9, 17) X(165, 42, 26) X(166, 14, 30) X(167, 48, 19) \
  X(168, 52, 41) X(169, 59, 20) X(170, 37, 60) X(171, 13, 59) X(172, 8, 0) X(173, 6, 24) \
  X(174, 21, 1) X(175, 13, 58) X(176, 38, 48) X(177, 55, 29) X(178, 44, 29) X(179, 24, 2) \
  X(180, 0, 17) X(181, 14, 25) X(182, 62, 39) X(183, 53, 63) X(184, 40, 34) X(185, 46, 23) \
  X(186, 16, 63) X(187, 40, 2) X(188, 36, 6) X(189, 36, 0) X(190, 56, 4) X(191, 5, 37) \
  X(192, 24, 4) X(193, 32, 51) X(194, 12, 63) X(195, 42, 63) X(196, 60, 20) X(197, 50, 34) \
  X(198, 59, 38) X(199, 61, 28) X(200, 49, 35) X(201, 32, 49) X(202, 21, 9) X(203, 3, 2) \
  X(204, 8, 29) X(205, 29, 37) X(206, 58, 19) X(207, 15, 28) X(208, 14, 27) X(209, 57, 14) \
  X(210, 3, 13) X(211, 14, 54) X(212, 7, 4) X(213, 8, 46) X(214, 34, 1) X(215, 22, 29) \
  X(216, 62, 12) X(217, 3, 51) X(218, 56, 13) X(219, 44, 55) X(220, 16, 2) X(221, 0, 29) \
  X(222, 25, 5) X(223, 5, 0) X(224, 3, 49) X(225, 36, 8) X(226, 5, 28) X(227, 54, 31) \
  X(228, 32, 26) X(229, 37, 16) X(230, 44, 62) X(231, 61, 33) X(232, 5, 17) X(233, 12, 57) \
  X(234, 7, 8) X(235, 28, 40) X(236, 9, 15) X(237, 25, 62) X(238, 32, 43) X(239, 57, 17) \
  X(240, 40, 50) X(241, 24, 63) X(242, 58, 35) X(243, 19, 11) X(244, 44, 27) X(245, 32, 36) \
  X(246, 27, 41) X(247, 36, 62) X(248, 51, 46) X(249, 22, 59) X(250, 33, 25) X(251, 39, 28) \
  X(252, 47, 55) X(253, 13, 60) X(254, 35, 59) X(255, 11, 37)

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
