"""Dataset calibration the port needs: the EuRoC MAV stereo rig.

A copy of the EuRoC part of lvt_tpu/io/datasets.py (its ``EUROC_*``
constants, the public calibration that the reference's EuRoC example
hardcodes), the two rectification maps ``EurocSequence`` builds from them,
and raw frames of the rig rendered from a point cloud (the renderer of
lvt_tpu's EuRoC CLI test), for runs without the dataset. The KITTI, EuRoC
and TUM sequence readers are not ported yet (ROADMAP Queue 1, the shells):
they read images with OpenCV or lvt_tpu's native loader.
"""

from __future__ import annotations

import numpy as np

from lvt_tpu_torch.ops.undistort import make_rectify_map

EUROC_KL = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1.0]])
EUROC_KR = np.array([[457.587, 0, 379.999], [0, 456.134, 255.238], [0, 0, 1.0]])
EUROC_DL = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0])
EUROC_DR = np.array([-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0])
EUROC_RL = np.array([
    [0.999966347530033, -0.001422739138722922, 0.008079580483432283],
    [0.001365741834644127, 0.9999741760894847, 0.007055629199258132],
    [-0.008089410156878961, -0.007044357138835809, 0.9999424675829176]])
EUROC_RR = np.array([
    [0.9999633526194376, -0.003625811871560086, 0.007755443660172947],
    [0.003680398547259526, 0.9999684752771629, -0.007035845251224894],
    [-0.007729688520722713, 0.007064130529506649, 0.999945173484644]])
EUROC_P = np.array([
    [435.2046959714599, 0, 367.4517211914062],
    [0, 435.2046959714599, 252.2008514404297],
    [0, 0, 1.0]])
EUROC_BASELINE = 0.110077842
EUROC_SIZE = (752, 480)
# body <- sensor transform of the left camera
EUROC_T_BS = np.array([
    [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
    [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
    [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
    [0.0, 0.0, 0.0, 1.0]])


def euroc_rectify_maps() -> tuple[np.ndarray, np.ndarray]:
    """The left and right [480, 752, 2] rectification maps of the EuRoC
    rig, for ``VOSystem(config, rectify_maps=...)``."""
    w, h = EUROC_SIZE
    return (make_rectify_map(w, h, EUROC_KL, EUROC_DL, EUROC_RL, EUROC_P),
            make_rectify_map(w, h, EUROC_KR, EUROC_DR, EUROC_RR, EUROC_P))


def render_euroc_raw(points: np.ndarray, intensities: np.ndarray,
                     t_rect: np.ndarray, right: bool) -> np.ndarray:
    """A raw (distorted, unrectified) uint8 frame of the left or right
    EuRoC camera whose rectified frame sits at ``t_rect`` (identity
    rotation): the world points [N, 3] go through the camera's rectifying
    rotation inverted, its distortion and K, and each visible one adds a
    Gaussian splat of its intensity to a background of 40 — the inverse of
    the rectification the step applies."""
    w, h = EUROC_SIZE
    k_mat = EUROC_KR if right else EUROC_KL
    dist = EUROC_DR if right else EUROC_DL
    r_rect = EUROC_RR if right else EUROC_RL
    t = t_rect + (np.array([EUROC_BASELINE, 0, 0]) if right else 0.0)
    p_cam = (points - t) @ r_rect  # x_raw = R^-1 @ x_rect (R orthonormal)
    z = p_cam[:, 2]
    vis = z > 0.5
    xn = p_cam[:, 0] / np.where(vis, z, 1.0)
    yn = p_cam[:, 1] / np.where(vis, z, 1.0)
    k1, k2, p1, p2, k3 = dist
    r2 = xn * xn + yn * yn
    radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
    u = k_mat[0, 0] * xd + k_mat[0, 2]
    v = k_mat[1, 1] * yd + k_mat[1, 2]
    m = 4
    vis &= (u > m) & (u < w - m) & (v > m) & (v < h - m)
    img = np.full((h, w), 40.0, np.float32)
    ku = np.arange(-m, m + 1)
    for ui, vi, ii in zip(u[vis], v[vis], intensities[vis]):
        x0, y0 = int(ui), int(vi)
        g = np.exp(-(((y0 + ku - vi)[:, None]) ** 2
                     + ((x0 + ku - ui)[None, :]) ** 2) / (2 * 1.1 ** 2))
        img[y0 - m:y0 + m + 1, x0 - m:x0 + m + 1] += ii * g
    return np.clip(img, 0, 255).astype(np.uint8)
