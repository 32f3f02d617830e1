"""Shipped configurations of the port.

* :func:`kitti_config` — path 1, the stereo main path: KITTI odometry
  sequence 00 intrinsics and baseline at 1241x376, 250-px cells of 150
  corners (1536 keypoint slots per image), 1024 map and 1024 staged
  points, patch descriptors, local BA off (the configuration of lvt_tpu's
  ``bench.py`` and ``__graft_entry__._kitti_config``);
* :func:`kitti_ba_dense_config` — path 2: ``kitti/vo_config.yaml`` (local
  BA window 4 every 4 frames) with ``kitti/00.yaml``'s calibration, in the
  dense descriptor mode;
* :func:`tum_rgbd_config` — the RGB-D sensor: ``tum_rgbd/config_tum{1,2,3}
  .yaml``, the TUM RGB-D freiburg 1-3 cameras at 640x480 with their
  distortion (fr1: k1 = 0.262, 8192 map points, one 2000-px cell of 1000
  corners, so 1024 keypoint slots, ``staged_threshold`` 0, BA off);
* :func:`euroc_config` — EuRoC MAV rectified stereo: ``euroc/vo_config
  .yaml`` at the rig's rectified intrinsics and baseline, 752x480, 250-px
  cells of 100 corners (896 keypoint slots), 4096 map points,
  ``staged_threshold`` 0, BA off. Its frames come raw and are rectified
  inside the step (``VOSystem(config, rectify_maps=io.datasets
  .euroc_rectify_maps())``).

The YAML files, and EuRoC's 11 sequence timestamp lists, are copies of
lvt_tpu/configs/kitti/, lvt_tpu/configs/tum_rgbd/ and
lvt_tpu/configs/euroc/.
"""

from __future__ import annotations

import os

from lvt_tpu_torch.config import VOConfig, load_config, load_kitti_calib

KITTI_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kitti")
TUM_RGBD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tum_rgbd")
EUROC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "euroc")


def kitti_config() -> VOConfig:
    """Path 1: KITTI sequence 00 geometry, patch descriptors, BA off."""
    return VOConfig(
        fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
        baseline=0.537165718864,
        img_width=1241, img_height=376,
        near_plane_distance=0.01, far_plane_distance=500.0,
        detection_cell_size=250, max_keypoints_per_cell=150,
        agast_threshold=25, staged_threshold=2, untracked_threshold=10,
        triangulation_policy=1,
        max_map_points=1024, max_staged_points=1024,
    )


def kitti_ba_dense_config() -> VOConfig:
    """Path 2: the shipped KITTI YAML (local BA on) with sequence 00's
    calibration and frame size, in the dense descriptor mode."""
    calib = load_kitti_calib(os.path.join(KITTI_DIR, "00.yaml"))
    return load_config(os.path.join(KITTI_DIR, "vo_config.yaml"), **calib,
                       img_width=1241, img_height=376,
                       descriptor_mode="dense")


def tum_rgbd_config(freiburg: int = 1) -> VOConfig:
    """The TUM RGB-D config of freiburg camera 1, 2 or 3, as lvt_tpu's TUM
    entry point loads it."""
    return load_config(os.path.join(TUM_RGBD_DIR,
                                    f"config_tum{int(freiburg)}.yaml"))


def euroc_config() -> VOConfig:
    """The EuRoC YAML with the rectified camera of the EuRoC rig, as
    lvt_tpu's ``EurocSequence.configure`` sets it."""
    from lvt_tpu_torch.io.datasets import EUROC_BASELINE, EUROC_P, EUROC_SIZE

    w, h = EUROC_SIZE
    return load_config(
        os.path.join(EUROC_DIR, "vo_config.yaml"),
        fx=float(EUROC_P[0, 0]), fy=float(EUROC_P[1, 1]),
        cx=float(EUROC_P[0, 2]), cy=float(EUROC_P[1, 2]),
        baseline=EUROC_BASELINE, img_width=w, img_height=h)
