// Device code shared by the two Levenberg-Marquardt kernels, PnP's solve
// (pnp_lm.cu) and local BA's refinement (ba.cu): the pose algebra, the
// pinhole projection, the Cauchy weight and the SE(3) retraction, each
// written operation by operation in the plain PyTorch version's order
// (lvt_tpu_torch/solver/pnp.py, solver/bundle.py, geometry/se3.py::matvec,
// geometry/quaternion.py) with __fmul_rn / __fadd_rn / __fdiv_rn, so that
// nvcc contracts no multiply and add into a fused one and the card rounds
// as torch's kernels do. A divisor that the plain version keeps as a
// device scalar (device.scalar) is divided by here too, never multiplied
// by its reciprocal. Besides, a warp's fold of float64 partial sums.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

struct Cam {
  float fx, fy, cx, cy, th2;
};

// row i of matvec(m, v) (geometry/se3.py): (v0 m_i0 + v1 m_i1) + v2 m_i2
__device__ __forceinline__ float mv(const float* m, int i, float a, float b,
                                    float c) {
  return __fadd_rn(
      __fadd_rn(__fmul_rn(a, m[3 * i]), __fmul_rn(b, m[3 * i + 1])),
      __fmul_rn(c, m[3 * i + 2]));
}

struct Proj {
  float px, py, pz, iz, rx, ry, e2;
};

// The pixel residual of the camera point (px, py, pz) against the
// observation (u, v), 1 / z and the squared error: _project_residuals
// (pnp.py), bundle.py::_project and _sq
__device__ __forceinline__ Proj project_cam(float px, float py, float pz,
                                            float u, float v, const Cam& c) {
  Proj o;
  o.px = px;
  o.py = py;
  o.pz = pz;
  o.iz = __fdiv_rn(1.0f, fabsf(pz) < 1e-9f ? 1e-9f : pz);
  o.rx = __fsub_rn(__fadd_rn(__fmul_rn(__fmul_rn(c.fx, px), o.iz), c.cx), u);
  o.ry = __fsub_rn(__fadd_rn(__fmul_rn(__fmul_rn(c.fy, py), o.iz), c.cy), v);
  o.e2 = __fadd_rn(__fmul_rn(o.rx, o.rx), __fmul_rn(o.ry, o.ry));
  return o;
}

// The world point (x, y, z) in the camera (r, t): matvec(r, p) + t
__device__ __forceinline__ void camera_point(const float* r, const float* t,
                                             float x, float y, float z,
                                             float& px, float& py,
                                             float& pz) {
  px = __fadd_rn(mv(r, 0, x, y, z), t[0]);
  py = __fadd_rn(mv(r, 1, x, y, z), t[1]);
  pz = __fadd_rn(mv(r, 2, x, y, z), t[2]);
}

// _project_residuals and the squared error at the pose (r, t)
__device__ __forceinline__ Proj project(const float* r, const float* t,
                                        float x, float y, float z, float u,
                                        float v, const Cam& c) {
  float px, py, pz;
  camera_point(r, t, x, y, z, px, py, pz);
  return project_cam(px, py, pz, u, v, c);
}

// w_mask * _cauchy_weights(e2, delta2)
__device__ __forceinline__ float cauchy(float wm, float e2, const Cam& c) {
  return __fmul_rn(wm, __fdiv_rn(1.0f, __fadd_rn(1.0f, __fdiv_rn(e2, c.th2))));
}

// quaternion.to_matrix, row major
__device__ void to_matrix(const float* q, float* m) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = __fmul_rn(x, x), yy = __fmul_rn(y, y), zz = __fmul_rn(z, z);
  const float xy = __fmul_rn(x, y), xz = __fmul_rn(x, z), yz = __fmul_rn(y, z);
  const float wx = __fmul_rn(w, x), wy = __fmul_rn(w, y), wz = __fmul_rn(w, z);
  m[0] = __fsub_rn(1.0f, __fmul_rn(2.0f, __fadd_rn(yy, zz)));
  m[1] = __fmul_rn(2.0f, __fsub_rn(xy, wz));
  m[2] = __fmul_rn(2.0f, __fadd_rn(xz, wy));
  m[3] = __fmul_rn(2.0f, __fadd_rn(xy, wz));
  m[4] = __fsub_rn(1.0f, __fmul_rn(2.0f, __fadd_rn(xx, zz)));
  m[5] = __fmul_rn(2.0f, __fsub_rn(yz, wx));
  m[6] = __fmul_rn(2.0f, __fsub_rn(xz, wy));
  m[7] = __fmul_rn(2.0f, __fadd_rn(yz, wx));
  m[8] = __fsub_rn(1.0f, __fmul_rn(2.0f, __fadd_rn(xx, yy)));
}

// quaternion.normalize: q / sqrt(((q0^2 + q1^2) + q2^2) + q3^2)
__device__ void normalize(float* q) {
  const float d = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(q[0], q[0]), __fmul_rn(q[1], q[1])),
                __fmul_rn(q[2], q[2])),
      __fmul_rn(q[3], q[3]));
  const float s = __fsqrt_rn(d);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = __fdiv_rn(q[i], s);
}

// The world-to-camera transform of a camera-in-world pose (t, q):
// r = to_matrix(q)^T, tw = -matvec(r, t)
__device__ void world_to_camera(const float* t, const float* q, float* r,
                                float* tw) {
  float r_cw[9];
  to_matrix(q, r_cw);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r[3 * i + j] = r_cw[3 * j + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) tw[i] = -mv(r, i, t[0], t[1], t[2]);
}

// The xor butterfly over a warp of the N values v[B, B + N) of each lane
// (N a power of two, at most 32), each lane keeping at each level the
// half of the values that its bit OFF selects and taking its partner's sum
// of that half: after it, lane l holds in v[B] value l / (32 / N), summed
// over the 32 lanes in exactly the full butterfly's pairs (a + b == b + a),
// with N - 1 + the remaining levels' shuffles instead of 5 N. Every index
// is a constant, so v stays in registers.
template <int B, int N, int OFF = 16, int T>
__device__ __forceinline__ void fold(double (&v)[T], int lane) {
  if constexpr (OFF > 0) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = (lane & OFF) != 0;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const double send = up ? v[B + j] : v[B + j + H];
        const double keep = up ? v[B + j + H] : v[B + j];
        v[B + j] = __dadd_rn(keep, __shfl_xor_sync(FULL, send, OFF));
      }
      fold<B, H, OFF / 2>(v, lane);
    } else {
      v[B] = __dadd_rn(v[B], __shfl_xor_sync(FULL, v[B], OFF));
      fold<B, 1, OFF / 2>(v, lane);
    }
  }
}

// _retract's rotation exp([w]x) of w = (w0, w1, w2), row major
__device__ __forceinline__ void exp_rotation(float w0, float w1, float w2,
                                             float (&dr)[9]) {
  const float theta2 = __fadd_rn(
      __fadd_rn(__fmul_rn(w0, w0), __fmul_rn(w1, w1)), __fmul_rn(w2, w2));
  const float theta = __fsqrt_rn(__fadd_rn(theta2, 1e-20f));
  const float half = __fmul_rn(0.5f, theta);
  const float sinc = theta < 1e-6f ? __fsub_rn(0.5f, __fdiv_rn(theta2, 48.0f))
                                   : __fdiv_rn(sinf(half), theta);
  float dq[4] = {cosf(half), __fmul_rn(sinc, w0), __fmul_rn(sinc, w1),
                 __fmul_rn(sinc, w2)};
  normalize(dq);
  to_matrix(dq, dr);
}

// Entry e of _retract's result (e < 9: R'[e / 3][e % 3]; else t'[e - 9])
// from dr = exp([w]x) and the entry's inputs: (x0, x1, x2) = (r[k], r[3 +
// k], r[6 + k]) for e = 3 i + k < 9, the pose's t for e >= 9 (then plus
// v, the step's translation v[e - 9]); e may vary by lane (the row of dr
// is picked by selects, so dr stays in registers)
__device__ __forceinline__ float retract_entry(const float (&dr)[9], int e,
                                               float x0, float x1, float x2,
                                               float v) {
  const int i = e < 9 ? e / 3 : e - 9;
  const float row[3] = {i == 0 ? dr[0] : (i == 1 ? dr[3] : dr[6]),
                        i == 0 ? dr[1] : (i == 1 ? dr[4] : dr[7]),
                        i == 0 ? dr[2] : (i == 1 ? dr[5] : dr[8])};
  const float x = mv(row, 0, x0, x1, x2);
  return e < 9 ? x : __fadd_rn(x, v);
}

// _retract(r, t, d) for xi = d = (v, w): R' = exp([w]x) R, t' = exp([w]x)
// t + v, into (r_out, t_out)
__device__ void retract(const float* r, const float* t, const float* d,
                        float* r_out, float* t_out) {
  float dr[9];
  exp_rotation(d[3], d[4], d[5], dr);
#pragma unroll
  for (int e = 0; e < 9; ++e)
    r_out[e] = retract_entry(dr, e, r[e % 3], r[3 + e % 3], r[6 + e % 3],
                             0.0f);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    t_out[i] = retract_entry(dr, 9 + i, t[0], t[1], t[2], d[i]);
}

}  // namespace
