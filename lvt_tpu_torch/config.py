"""Configuration for the VO pipeline: the port's own copy of
lvt_tpu/config.py, with the same fields, defaults, validation and YAML
loading, so the port imports nothing of the JAX package.

Equivalent of the reference's ``lvt_parameters`` (lvt/src/lvt_parameters.h:29-64,
defaults lvt/src/lvt_parameters.cpp:29-52) with the compile-time constants of
``lvt_definitions.h:29-34`` promoted to config fields, plus the static
capacities (padded keypoint / map sizes) that fix all tensor shapes. The
backend fields (``use_pallas_*``, ``use_mxu_hamming``, ``int16_perception``,
``gather_mode``, ``pallas_matching_sites``) select JAX/TPU code paths; the
port keeps them so a config means the same in both packages, and ignores
them.

The config is a frozen (hashable) dataclass: every field here is shape- or
trace-constant. YAML loading understands both plain YAML and the OpenCV
``%YAML:1.0`` dialect used by the reference's config files (e.g.
examples/kitti/vo_config.yaml).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

import yaml

# -- constants from the reference (lvt_definitions.h:29-34), promoted to
#    config fields below but kept as module defaults
REPROJECTION_TH2 = 5.991  # chi-square 95% upper bound, 2 DoF
N_MAP_POINTS_SOFT_CAP = 250
ROW_MATCHING_VERTICAL_SEARCH_RADIUS = 2
HASHING_CELL_SIZE = 25  # unused on TPU (dense masks replace the hash grid)
CORNERS_LOW_TH = 200
N_MATCHES_TH = 50

# sentinel for "infinitely many matches" in the triangulation-policy window
# (the reference uses INT_MAX in a deque; we keep arithmetic in float32)
MATCHES_WINDOW_INIT = 1.0e9


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class VOConfig:
    """Static configuration of a VO system instance."""

    # ---- camera (must be specified; stereo assumed undistorted + rectified)
    fx: float = 0.5
    fy: float = 0.5
    cx: float = 0.5
    cy: float = 0.5
    baseline: float = 0.0
    img_width: int = 0
    img_height: int = 0
    # distortion (RGB-D path only; stereo input is pre-rectified)
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0

    # ---- matching / tracking knobs (reference defaults)
    near_plane_distance: float = 0.1
    far_plane_distance: float = 500.0
    triangulation_ratio_test_threshold: float = 0.60
    tracking_ratio_test_threshold: float = 0.80
    descriptor_matching_threshold: float = 30.0
    min_num_matches_for_tracking: int = 10
    tracking_radius: int = 25
    detection_cell_size: int = 250
    max_keypoints_per_cell: int = 150
    agast_threshold: int = 25
    untracked_threshold: int = 10
    staged_threshold: int = 2
    # 1 = decreasing matches, 2 = always triangulate, 3 = map size < 1000
    triangulation_policy: int = 1

    # ---- constants promoted from lvt_definitions.h
    reprojection_th2: float = REPROJECTION_TH2
    map_soft_cap: int = N_MAP_POINTS_SOFT_CAP
    row_matching_vertical_search_radius: int = ROW_MATCHING_VERTICAL_SEARCH_RADIUS
    corners_low_threshold: int = CORNERS_LOW_TH
    n_matches_threshold: int = N_MATCHES_TH

    # ---- TPU-native static capacities (all shapes derive from these)
    max_map_points: int = 1024      # hard capacity of the local map SoA
    max_staged_points: int = 1024   # hard capacity of the staging buffer
    max_keypoints: int = 0          # 0 => derived from the detection grid

    # ---- local bundle adjustment (opt-in accuracy feature; the reference
    # has no structure refinement at all — motion-only BA with fixed points)
    local_ba_window: int = 0       # sliding-window size F (0 = disabled)
    local_ba_every: int = 4        # run BA every N tracked frames
    local_ba_iterations: int = 6   # LM iterations per refinement

    # ---- backend selection: fused Pallas kernels (None = auto:
    # on for TPU backends, off elsewhere)
    use_pallas_perception: bool | None = None
    # Hamming distances via an MXU +-1 bf16 matmul instead of the 8-pass
    # XOR+popcount reduction (exact; None = auto on TPU)
    use_mxu_hamming: bool | None = None
    # fused masked top-2 matching kernel (ops/top2_pallas.py); None = auto
    # on TPU. History: under the old lax.switch state machine the full step
    # instantiated the row-mode kernel TWICE (init + track branches) and hit
    # a runtime "TPU backend error (InvalidArgument)" on the first tracking
    # frame (bisected by scripts/tpu_top2_bisect.py: any composition
    # containing the duplicated row instance failed, every single-instance
    # site passed). The predicated single-branch step (core/step.py
    # track_features) instantiates each kernel once and the full
    # composition runs clean, so the kernel is now default-on for TPU.
    use_pallas_matching: bool | None = None
    # which call sites use the fused kernel when it is enabled:
    # m = map matching (find_map_matches), r = stereo row match,
    # s = staged-point re-match. Lets the kernel land partially and lets
    # the TPU bisection scripts isolate a failing composition.
    pallas_matching_sites: str = "mrs"
    # legacy BRIEF strategy toggle, kept for config compatibility; since
    # r5 ``descriptor_mode`` below is the real knob (this field only maps
    # use_dense_brief=False -> descriptor_mode "sparse" when
    # descriptor_mode is unset). History: the sparse XLA gather measured
    # 538 -> 283 fps on v5e in r4; the r5 patch kernel is the dedicated
    # gather that finally retired the dense planes.
    use_dense_brief: bool = True
    # descriptor/subpixel formation strategy (None = auto):
    #   "patch"  — Pallas patch-extraction kernel (ops/patches_pallas):
    #              whole smooth/raw maps VMEM-resident, one contiguous
    #              32x32 patch per keypoint, descriptors via exact one-hot
    #              MXU matmuls. Kills the dense bit-plane kernel B, its
    #              crop, and every scattered per-keypoint gather (the r4
    #              "gather tax", ~0.5 ms/frame-stream). TPU default (r5).
    #   "dense"  — dense BRIEF bit-planes + per-keypoint gather (the r3/r4
    #              production path; CPU default)
    #   "sparse" — per-keypoint flat-take of the 64 pool samples (kept as
    #              measured evidence: 538 -> 283 fps on v5e)
    # auto resolves: explicit use_dense_brief=False -> "sparse";
    # TPU + Pallas perception -> "patch"; else "dense". All modes produce
    # bit-identical descriptors at valid keypoints.
    descriptor_mode: str | None = None
    # int16 perception-kernel compute for uint8 frames (exact; see
    # ops/perception_pallas._run_kernel_a). None = kernel-module default.
    # r5 hardware campaign: BLOCKED on this toolchain (Mosaic legalizes no
    # 16-bit vector min/cmp — and the bf16 variant hits "Target does not
    # support this comparison"), so the default stays off; the flag is a
    # static jit argument and stays interpret-testable.
    int16_perception: bool | None = None
    # per-keypoint lookup lowering (scripts/bench_gather.py, v5e):
    #   "scatter" — XLA advanced-indexing gathers (132 us/frame-equiv in
    #               the ISOLATED microbench; production default)
    #   "flat"    — single flat jnp.take formulations: 77 us isolated, but
    #               the FULL step measured 512 vs 536 fps — the microbench
    #               win does not survive fusion context
    #   "slice"   — vmapped contiguous dynamic_slice: 2500 us, 19x worse
    # Both alternatives kept as measured evidence; None = auto (scatter)
    gather_mode: str | None = None

    # ---- observability
    enable_logging: bool = False
    enable_metrics: bool = False

    # ------------------------------------------------------------------
    # derived static geometry
    # ------------------------------------------------------------------
    @property
    def num_cells_x(self) -> int:
        return 1 + (self.img_width - 1) // self.detection_cell_size

    @property
    def num_cells_y(self) -> int:
        return 1 + (self.img_height - 1) // self.detection_cell_size

    @property
    def num_cells(self) -> int:
        return self.num_cells_x * self.num_cells_y

    @property
    def kp_capacity(self) -> int:
        """Static padded keypoint count per frame (lane-aligned)."""
        if self.max_keypoints:
            return self.max_keypoints
        return max(128, _round_up(self.num_cells * self.max_keypoints_per_cell, 128))

    @property
    def cell_kp_capacity(self) -> int:
        return self.max_keypoints_per_cell

    def validate(self) -> "VOConfig":
        assert self.img_width > 0 and self.img_height > 0, "image size must be set"
        assert self.detection_cell_size > 0
        assert self.max_keypoints_per_cell > 0
        assert self.tracking_radius > 0
        assert self.agast_threshold > 0
        return self

    def replace(self, **kw: Any) -> "VOConfig":
        return dataclasses.replace(self, **kw)


_INT_FIELDS = {
    f.name
    for f in dataclasses.fields(VOConfig)
    if f.type in ("int", int)
}
_BOOL_FIELDS = {"enable_logging", "enable_metrics"}

# map legacy reference YAML keys to config fields where names differ
_KEY_ALIASES = {
    "enable_visualization": None,       # host-side concern; ignored
    "viewer_camera_size": None,
    "viewer_point_size": None,
    # present in reference YAMLs but ignored by its loader (compile-time
    # consts there); we *do* honor them:
    "hashing_cell_size": None,          # no hash grid in the dense design
    "row_matching_vertical_search_radius": "row_matching_vertical_search_radius",
}


def parse_opencv_yaml(text: str) -> dict:
    """Parse plain YAML or OpenCV's %YAML:1.0 dialect into a dict.

    Handles the ``!!opencv-matrix`` tag used by KITTI calib files
    (reference: examples/kitti/calib/00.yml).
    """
    text = re.sub(r"^%YAML:[\d.]+\s*\n", "", text)
    text = text.replace("!!opencv-matrix", "")
    data = yaml.safe_load(text)
    return data or {}


def load_config(path: str, **overrides: Any) -> VOConfig:
    """Load a VOConfig from a YAML file (reference-compatible keys)."""
    with open(path) as f:
        data = parse_opencv_yaml(f.read())
    kw: dict[str, Any] = {}
    valid = {f.name for f in dataclasses.fields(VOConfig)}
    for key, value in data.items():
        key = _KEY_ALIASES.get(key, key)
        if key is None or key not in valid or value is None:
            continue
        if key in _BOOL_FIELDS:
            value = bool(int(value))
        elif key in _INT_FIELDS:
            value = int(value)
        elif isinstance(value, (int, float)):
            value = float(value)
        kw[key] = value
    kw.update(overrides)
    return VOConfig(**kw)


def load_kitti_calib(path: str) -> dict:
    """Load a KITTI calib YAML (camera_matrix + baseline) into intrinsics."""
    with open(path) as f:
        data = parse_opencv_yaml(f.read())
    m = data["camera_matrix"]["data"]
    return {
        "fx": float(m[0]),
        "cx": float(m[2]),
        "fy": float(m[4]),
        "cy": float(m[5]),
        "baseline": float(data["baseline"]),
    }
