"""Trajectory files in the standard evaluation formats, and ATE / RPE.

Port of lvt_tpu/io/trajectory.py: KITTI format (a row-major 3x4
camera-to-world matrix per line) and TUM format (``stamp tx ty tz qx qy
qz qw``), which the KITTI devkit, evo and the TUM scripts read, written
byte for byte as lvt_tpu writes them for equal poses; and the trajectory
errors in numpy. A pose may lie on any device: it is read through one
host copy, and its rotation matrix is computed on the CPU in float32, as
lvt_tpu computes it.
"""

from __future__ import annotations

import numpy as np
import torch

from lvt_tpu_torch.geometry import quaternion as quat
from lvt_tpu_torch.geometry.se3 import Pose


def _host(pose: Pose) -> tuple[torch.Tensor, torch.Tensor]:
    """(t [3], q [4]) of ``pose`` on the CPU, in one copy."""
    tq = torch.cat([pose.t.reshape(3), pose.q.reshape(4)]).cpu()
    return tq[:3], tq[3:]


def pose_to_rt(pose: Pose) -> tuple[np.ndarray, np.ndarray]:
    t, q = _host(pose)
    return (quat.to_matrix(q).numpy().astype(np.float64),
            t.numpy().astype(np.float64))


def dump_kitti(path: str, poses: list[Pose]) -> None:
    with open(path, "w") as f:
        for pose in poses:
            r, t = pose_to_rt(pose)
            m = np.hstack([r, t[:, None]]).reshape(-1)
            f.write(" ".join(f"{v:.9f}" for v in m) + "\n")


def dump_tum(path: str, poses: list[Pose], stamps: list[float]) -> None:
    with open(path, "w") as f:
        for pose, ts in zip(poses, stamps):
            t, q = (x.numpy().astype(np.float64) for x in _host(pose))
            # q is (w, x, y, z); TUM writes qx qy qz qw
            f.write(
                f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n"
            )


def load_kitti(path: str) -> np.ndarray:
    """[N, 3, 4] camera-to-world matrices."""
    return np.loadtxt(path).reshape(-1, 3, 4)


def load_tum(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(stamps [N], positions [N, 3]); quaternions ignored for ATE."""
    data = np.loadtxt(path, comments="#")
    return data[:, 0], data[:, 1:4]


def ate_rmse_aligned(est_xyz: np.ndarray, gt_xyz: np.ndarray) -> float:
    """Absolute trajectory error after SE(3) (Horn/Umeyama) alignment, the
    standard KITTI/TUM ATE metric."""
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    ec, gc = est - mu_e, gt - mu_g
    h = ec.T @ gc
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    s = np.diag([1.0, 1.0, d])
    r = vt.T @ s @ u.T
    aligned = ec @ r.T + mu_g
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=-1))))


def rpe_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray, delta: int = 1) -> float:
    """Relative pose (translation drift) error over ``delta``-frame
    intervals."""
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    de = est[delta:] - est[:-delta]
    dg = gt[delta:] - gt[:-delta]
    return float(np.sqrt(np.mean(np.sum((de - dg) ** 2, axis=-1))))


def rot_rmse_deg(est_r: np.ndarray, gt_r: np.ndarray) -> float:
    """Rotation error RMSE in degrees: the per-frame geodesic angle between
    estimated and ground-truth orientation, both anchored to the shared
    first-frame identity."""
    est = np.asarray(est_r, np.float64)
    gt = np.asarray(gt_r, np.float64)
    rel = np.einsum("nij,nik->njk", est, gt)   # est^T @ gt per frame
    tr = np.clip((np.trace(rel, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    ang = np.degrees(np.arccos(tr))
    return float(np.sqrt(np.mean(ang**2)))
