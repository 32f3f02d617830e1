"""Dataset readers: KITTI odometry, EuRoC MAV, TUM RGB-D.

Port of lvt_tpu/io/datasets.py: the three sequence readers of the
reference's example drivers (examples/kitti/kitti_example.cpp:62-104,
examples/euroc/euroc_example.cpp:63-143, examples/tum_rgbd/
tum_rgbd_example.cpp:62-132), yielding numpy frames; the EuRoC rig's
public calibration (the ``EUROC_*`` constants its example hardcodes) and
the two rectification maps built from it; and raw frames of the rig
rendered from a point cloud (the renderer of lvt_tpu's EuRoC CLI test),
for runs without the dataset.

PNGs are decoded by the port's own decoder (``io.native_loader``); OpenCV
reads only files that are not PNGs, where it is installed. A PNG the
decoder rejects raises: there is no silent fallback.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np
import torch

from lvt_tpu_torch.config import VOConfig, load_kitti_calib
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.io import native_loader
from lvt_tpu_torch.ops.undistort import make_rectify_map, remap_bilinear

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                          "configs")


def _imread_cv2(path: str, flag_name: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, getattr(cv2, flag_name))
    if img is None:
        raise FileNotFoundError(path)
    return img


def imread_gray(path: str) -> np.ndarray:
    """Grayscale image load (uint8 [H, W])."""
    if native_loader.is_png(path):
        return native_loader.imread_gray_native(path)
    return _imread_cv2(path, "IMREAD_GRAYSCALE")


def imread_raw(path: str) -> np.ndarray:
    """Load keeping dtype and channels (16-bit TUM depth PNGs)."""
    if native_loader.is_png(path):
        return native_loader.imread_native(path)
    return _imread_cv2(path, "IMREAD_UNCHANGED")


# ----------------------------------------------------------------------
# KITTI odometry
# ----------------------------------------------------------------------
class KittiSequence:
    """KITTI odometry grayscale stereo sequence (image_0/image_1)."""

    def __init__(self, sequences_dir: str, seq: int,
                 calib_path: str | None = None):
        self.seq = seq
        self.dir = os.path.join(sequences_dir, f"{seq:02d}")
        self.left_dir = os.path.join(self.dir, "image_0")
        self.right_dir = os.path.join(self.dir, "image_1")
        if calib_path is None:
            calib_path = os.path.join(CONFIG_DIR, "kitti", f"{seq:02d}.yaml")
        self.calib = load_kitti_calib(calib_path)
        self.frames = sorted(
            f for f in os.listdir(self.left_dir) if f.endswith(".png"))

    def __len__(self) -> int:
        return len(self.frames)

    def probe_image_size(self) -> tuple[int, int]:
        img = imread_gray(os.path.join(self.left_dir, self.frames[0]))
        return img.shape[1], img.shape[0]

    def configure(self, config: VOConfig) -> VOConfig:
        w, h = self.probe_image_size()
        return config.replace(img_width=w, img_height=h, **self.calib)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        for name in self.frames:
            yield (imread_gray(os.path.join(self.left_dir, name)),
                   imread_gray(os.path.join(self.right_dir, name)))


# ----------------------------------------------------------------------
# EuRoC MAV
# ----------------------------------------------------------------------
# Public EuRoC camera calibration, as the reference's EuRoC example
# hardcodes it (examples/euroc/euroc_example.cpp:95-119).
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


def euroc_body_pose(pose: Pose) -> Pose:
    """A left-camera pose in the EuRoC body frame, ``T_BS @ T_cam``
    (euroc_example.cpp:153-158), as lvt_tpu's EuRoC driver computes it: the
    float32 4x4 times EUROC_T_BS in float64, rounded to float32, on the
    CPU."""
    m = EUROC_T_BS @ pose.matrix44().cpu().numpy()
    return Pose.from_matrix44(torch.as_tensor(m, dtype=torch.float32))


class EurocSequence:
    """EuRoC stereo sequence; its frames are raw (distorted, unrectified),
    for ``VOSystem(config, rectify_maps=(seq.map_l, seq.map_r))``, which
    remaps them inside the step, or for :meth:`rectify`."""

    def __init__(self, root_dir: str, dataset_name: str,
                 stamps_path: str | None = None):
        self.seq_dir = os.path.join(root_dir, dataset_name, "mav0")
        if stamps_path is None:
            stamps_path = os.path.join(CONFIG_DIR, "euroc",
                                       f"{dataset_name}.txt")
        self.titles: list[str] = []
        self.stamps: list[float] = []
        with open(stamps_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                name = line.split()[0]
                self.titles.append(name + ".png")
                self.stamps.append(float(name) / 1e9)
        self.map_l, self.map_r = euroc_rectify_maps()

    def __len__(self) -> int:
        return len(self.titles)

    def configure(self, config: VOConfig) -> VOConfig:
        w, h = EUROC_SIZE
        return config.replace(
            fx=float(EUROC_P[0, 0]), fy=float(EUROC_P[1, 1]),
            cx=float(EUROC_P[0, 2]), cy=float(EUROC_P[1, 2]),
            baseline=EUROC_BASELINE, img_width=w, img_height=h)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yields the raw frames."""
        for name in self.titles:
            yield (
                imread_gray(os.path.join(self.seq_dir, "cam0", "data", name)),
                imread_gray(os.path.join(self.seq_dir, "cam1", "data", name)),
            )

    def rectify(self, img_left, img_right):
        """The rectified float32 pair, on the images' device (a numpy frame
        is on the CPU): ``remap_bilinear`` through the two maps."""
        left, right = torch.as_tensor(img_left), torch.as_tensor(img_right)
        return (remap_bilinear(left, torch.as_tensor(self.map_l).to(
                    left.device)),
                remap_bilinear(right, torch.as_tensor(self.map_r).to(
                    right.device)))


# ----------------------------------------------------------------------
# TUM RGB-D
# ----------------------------------------------------------------------
TUM_DEPTH_SCALE = 1.0 / 5000.0  # tum_rgbd_example.cpp:111


class TumRgbdSequence:
    """TUM RGB-D sequence through an association file (rgb <-> depth
    pairs)."""

    def __init__(self, dataset_dir: str, association_path: str | None = None):
        self.dir = dataset_dir
        if association_path is None:
            name = os.path.basename(os.path.normpath(dataset_dir))
            association_path = os.path.join(
                CONFIG_DIR, "tum_rgbd", "associations", f"{name}.txt")
        self.entries: list[tuple[float, str, str]] = []
        with open(association_path) as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) >= 4 and not line.startswith("#"):
                    self.entries.append((float(parts[0]), parts[1], parts[3]))

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def stamps(self) -> list[float]:
        return [e[0] for e in self.entries]

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yields (grayscale uint8, metric depth float32)."""
        for _, rgb_rel, depth_rel in self.entries:
            rgb = imread_gray(os.path.join(self.dir, rgb_rel))
            depth_raw = imread_raw(os.path.join(self.dir, depth_rel))
            yield rgb, depth_raw.astype(np.float32) * TUM_DEPTH_SCALE


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
