"""Synthetic 3D world renderer for dataset-free testing and benchmarking:
the port's own copy of lvt_tpu/io/synthetic.py (numpy only), which renders
the same frames and poses from the same seed.

The reference has no tests and validates only against datasets (SURVEY.md
section 4); this module provides the synthetic-world integration harness the
framework is tested and benchmarked with when no dataset is on disk: a random
3D point cloud rendered as Gaussian splats into stereo (or RGB-D) frames from
a scripted camera trajectory, so the recovered trajectory can be compared
against ground truth with no external data.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticWorld:
    width: int = 640
    height: int = 480
    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    baseline: float = 0.3
    n_points: int = 4000
    seed: int = 7
    background: float = 40.0
    blob_sigma: float = 1.1
    extent_x: float = 60.0
    extent_y: float = 25.0
    extent_z: float = 120.0

    def __post_init__(self):
        rs = np.random.RandomState(self.seed)
        self.points = np.stack(
            [
                rs.uniform(-self.extent_x, self.extent_x, self.n_points),
                rs.uniform(-self.extent_y, self.extent_y, self.n_points),
                rs.uniform(2.0, self.extent_z, self.n_points),
            ],
            axis=-1,
        )
        self.intensities = rs.uniform(60.0, 215.0, self.n_points)

    # -- camera trajectory ---------------------------------------------
    def trajectory(self, n_frames: int, speed: float = 0.8,
                   yaw_rate: float = 0.002) -> list[tuple[np.ndarray, np.ndarray]]:
        """Forward motion with gentle yaw. Returns [(R_c2w, t_c2w)] per frame."""
        poses = []
        pos = np.zeros(3)
        yaw = 0.0
        for _ in range(n_frames):
            c, s = np.cos(yaw), np.sin(yaw)
            r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            poses.append((r, pos.copy()))
            pos = pos + r @ np.array([0.0, 0.0, speed])
            yaw += yaw_rate
        return poses

    # -- rendering ------------------------------------------------------
    def render(self, r_c2w: np.ndarray, t_c2w: np.ndarray,
               right: bool = False) -> np.ndarray:
        """Render one grayscale frame with bilinear-positioned blobs."""
        r_w2c = r_c2w.T
        t = t_c2w.copy()
        if right:
            t = t + r_c2w @ np.array([self.baseline, 0.0, 0.0])
        p_cam = (self.points - t) @ r_w2c.T
        z = p_cam[:, 2]
        vis = z > 0.5
        u = self.fx * p_cam[:, 0] / np.where(vis, z, 1.0) + self.cx
        v = self.fy * p_cam[:, 1] / np.where(vis, z, 1.0) + self.cy
        m = 4
        vis &= (u > m) & (u < self.width - m) & (v > m) & (v < self.height - m)

        img = np.full((self.height, self.width), self.background, np.float32)
        ku = np.arange(-m, m + 1)
        for ui, vi, ii in zip(u[vis], v[vis], self.intensities[vis]):
            x0, y0 = int(ui), int(vi)
            dx = x0 + ku - ui
            dy = y0 + ku - vi
            g = np.exp(-(dy[:, None] ** 2 + dx[None, :] ** 2)
                       / (2 * self.blob_sigma**2))
            img[y0 - m : y0 + m + 1, x0 - m : x0 + m + 1] += ii * g
        return np.clip(img, 0.0, 255.0)

    def render_depth(self, r_c2w: np.ndarray, t_c2w: np.ndarray) -> np.ndarray:
        """Depth image: each blob's footprint takes its point's depth
        (nearest wins), background = 0 (invalid)."""
        r_w2c = r_c2w.T
        p_cam = (self.points - t_c2w) @ r_w2c.T
        z = p_cam[:, 2]
        vis = z > 0.5
        u = self.fx * p_cam[:, 0] / np.where(vis, z, 1.0) + self.cx
        v = self.fy * p_cam[:, 1] / np.where(vis, z, 1.0) + self.cy
        m = 4
        vis &= (u > m) & (u < self.width - m) & (v > m) & (v < self.height - m)
        depth = np.full((self.height, self.width), np.inf, np.float32)
        for ui, vi, zi in zip(u[vis], v[vis], z[vis]):
            x0, y0 = int(ui), int(vi)
            patch = depth[y0 - m : y0 + m + 1, x0 - m : x0 + m + 1]
            np.minimum(patch, zi, out=patch)
        depth[~np.isfinite(depth)] = 0.0
        return depth

    def stereo_sequence(self, n_frames: int, **kw):
        """Yields (img_left, img_right, (R_c2w, t_c2w)) per frame."""
        for r, t in self.trajectory(n_frames, **kw):
            yield self.render(r, t), self.render(r, t, right=True), (r, t)

    def rgbd_sequence(self, n_frames: int, **kw):
        for r, t in self.trajectory(n_frames, **kw):
            yield self.render(r, t), self.render_depth(r, t), (r, t)


# ---------------------------------------------------------------------------
# Textured world: natural-imagery-like procedural scenes
# ---------------------------------------------------------------------------
#
# The blob world above renders isolated Gaussian splats — ideal features.
# Real imagery (the reference's entire validation diet: KITTI streets, EuRoC
# halls, TUM desks) is dense texture, repetitive structure, low-texture
# regions, occlusions and illumination change. TexturedWorld ray-casts a
# corridor of noise-textured planes so FAST/BRIEF run on dense natural-like
# gradients with exact ground-truth geometry (and exact depth for RGB-D):
#
#   * multi-octave value noise per plane (lattice-hash based, deterministic);
#   * footprint-based octave attenuation (a cheap mip-map) so distant
#     texture fades instead of aliasing frame to frame;
#   * optional periodic stripes on the walls (repetitive-structure stress
#     for the descriptor ratio test);
#   * optional moving textured occluder quads (dynamic objects violating
#     the rigid-world assumption — robustness stress for the Cauchy PnP);
#   * texture_amp scales local contrast (low-texture stress).


def _hash01(ix: np.ndarray, iy: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic lattice hash -> [0, 1) (integer mix, no RNG state)."""
    h = (ix * np.int64(374761393)) ^ (iy * np.int64(668265263)) \
        ^ np.int64(seed * 974634599)
    h = (h ^ (h >> 13)) * np.int64(1274126177)
    h &= np.int64(0x7FFFFFFFFFFFFFFF)
    return ((h >> 16) & np.int64(0xFFFF)).astype(np.float32) / 65535.0


def _lattice_noise(u: np.ndarray, v: np.ndarray, seed: int) -> np.ndarray:
    """Smoothstep-interpolated value noise on the unit lattice."""
    iu = np.floor(u)
    iv = np.floor(v)
    fu = (u - iu).astype(np.float32)
    fv = (v - iv).astype(np.float32)
    su = fu * fu * (3.0 - 2.0 * fu)
    sv = fv * fv * (3.0 - 2.0 * fv)
    iu = iu.astype(np.int64)
    iv = iv.astype(np.int64)
    a = _hash01(iu, iv, seed)
    b = _hash01(iu + 1, iv, seed)
    c = _hash01(iu, iv + 1, seed)
    d = _hash01(iu + 1, iv + 1, seed)
    return a + su * (b - a) + sv * (c - a) + su * sv * (a - b - c + d)


@dataclasses.dataclass
class TexturedWorld:
    """Procedurally textured corridor world (ray-cast planes).

    Same camera interface as SyntheticWorld (the parity scenarios swap the
    two freely): x right, y down, z forward; ground below (+y), ceiling
    above, walls at +-wall_x; the scripted trajectory moves forward with
    gentle yaw down the corridor.
    """

    width: int = 640
    height: int = 480
    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    baseline: float = 0.3
    seed: int = 11
    ground_y: float = 2.2
    ceiling_y: float = -7.0
    wall_x: float = 16.0
    base_intensity: float = 110.0
    # local contrast; 160 yields KITTI-like FAST-9/16 corner density
    # (~2300 corners @ threshold 25 on 640x480); ~45 is low-texture stress
    texture_amp: float = 160.0
    texel: float = 0.6            # coarsest octave feature size (meters)
    octaves: int = 5
    stripe_walls: bool = False    # periodic vertical stripes on both walls
    stripe_period: float = 1.2    # meters
    n_occluders: int = 0          # moving textured quads (dynamic objects)

    def __post_init__(self):
        j, i = np.meshgrid(
            np.arange(self.width, dtype=np.float32),
            np.arange(self.height, dtype=np.float32),
        )
        # camera-frame ray per pixel, z component fixed at 1 so the plane
        # parameter t IS the camera z-depth
        self._dirs_cam = np.stack(
            [(j - self.cx) / self.fx, (i - self.cy) / self.fy,
             np.ones_like(j)], axis=-1,
        )
        # (axis, plane value, texture seed offset, is_wall)
        self._planes = [
            (1, self.ground_y, 0, False),
            (1, self.ceiling_y, 100, False),
            (0, -self.wall_x, 200, True),
            (0, self.wall_x, 300, True),
        ]
        rs = np.random.RandomState(self.seed)
        # occluders: quads on world plane z = z0 + vz * frame, drifting
        # laterally; sized ~1-2.5 m
        self._occluders = [
            dict(
                x0=rs.uniform(-6.0, 6.0), y0=rs.uniform(-2.0, 1.0),
                z0=rs.uniform(12.0, 30.0 + 14.0 * k),
                vx=rs.uniform(-0.06, 0.06), vz=rs.uniform(0.2, 0.7),
                hx=rs.uniform(0.8, 1.6), hy=rs.uniform(0.6, 1.2),
                seed=400 + 17 * k,
            )
            for k in range(self.n_occluders)
        ]

    # same scripted trajectory as the blob world
    trajectory = SyntheticWorld.trajectory

    def _texture(self, pu, pv, dist, cos_inc, seed):
        """Multi-octave value noise in [-0.5, 0.5] with footprint LOD."""
        foot = dist / self.fx / np.maximum(cos_inc, 0.25)
        out = np.zeros(pu.shape, np.float32)
        tot = np.zeros(pu.shape, np.float32)
        amp = 1.0
        for o in range(self.octaves):
            size = self.texel / (2.0**o)
            w = amp * np.clip(size / np.maximum(foot, 1e-6) - 0.5, 0.0, 1.0)
            n = _lattice_noise(pu / size, pv / size, seed + o)
            out += w * (n - 0.5)
            tot += w
            amp *= 0.6
        return out / np.maximum(tot, 1e-6) * 0.5

    def render_frame(
        self, r_c2w: np.ndarray, t_c2w: np.ndarray,
        right: bool = False, frame: int = 0,
    ) -> tuple[np.ndarray, np.ndarray]:
        """One grayscale frame + its exact z-depth map."""
        t = np.asarray(t_c2w, np.float32).copy()
        if right:
            t = t + (r_c2w @ np.array([self.baseline, 0.0, 0.0])).astype(
                np.float32)
        dirs = (self._dirs_cam @ np.asarray(r_c2w, np.float32).T)
        dirs = dirs.reshape(-1, 3)
        norm = np.linalg.norm(dirs, axis=-1)
        n_px = dirs.shape[0]
        best_t = np.full(n_px, np.inf, np.float32)
        img = np.full(n_px, self.base_intensity, np.float32)

        def shade(idx, tt, pu, pv, d_ax, seed, stripe_coord=None):
            # texture evaluated only on the hit subset (the octave loop is
            # the render cost; planes each cover a fraction of the frame)
            dist = tt * norm[idx]
            cosi = np.abs(d_ax) / norm[idx]
            tex = self._texture(pu, pv, dist, cosi, self.seed * 1000 + seed)
            col = self.base_intensity + self.texture_amp * 2.0 * tex
            if stripe_coord is not None:
                # repetitive structure: hard periodic stripes modulate the
                # noise so distinct wall locations look locally identical
                phase = np.sin(2.0 * np.pi * stripe_coord / self.stripe_period)
                col = col + 45.0 * np.sign(phase) * (np.abs(phase) > 0.15)
            img[idx] = col
            best_t[idx] = tt

        for axis, value, seed, is_wall in self._planes:
            d_ax = dirs[:, axis]
            denom = np.where(np.abs(d_ax) < 1e-7,
                             np.where(d_ax < 0, -1e-7, 1e-7), d_ax)
            tt = ((value - t[axis]) / denom).astype(np.float32)
            idx = np.nonzero((tt > 0.05) & (tt < best_t))[0]
            tt = tt[idx]
            ax_u, ax_v = (0, 2) if axis == 1 else (1, 2)
            pu = t[ax_u] + tt * dirs[idx, ax_u]
            pv = t[ax_v] + tt * dirs[idx, ax_v]
            shade(idx, tt, pu, pv, d_ax[idx], seed,
                  stripe_coord=pv if (is_wall and self.stripe_walls) else None)

        for occ in self._occluders:
            z = occ["z0"] - occ["vz"] * frame          # moving toward camera
            x_c = occ["x0"] + occ["vx"] * frame * 10.0  # lateral drift
            d_ax = dirs[:, 2]
            denom = np.where(np.abs(d_ax) < 1e-7, 1e-7, d_ax)
            tt = ((z - t[2]) / denom).astype(np.float32)
            pu = t[0] + tt * dirs[:, 0]
            pv = t[1] + tt * dirs[:, 1]
            idx = np.nonzero(
                (tt > 0.05) & (tt < best_t)
                & (np.abs(pu - x_c) < occ["hx"])
                & (np.abs(pv - occ["y0"]) < occ["hy"])
            )[0]
            shade(idx, tt[idx], pu[idx] * 3.0, pv[idx] * 3.0, d_ax[idx],
                  occ["seed"])

        shape = (self.height, self.width)
        return (
            np.clip(img, 0.0, 255.0).reshape(shape),
            np.where(np.isfinite(best_t), best_t, 0.0)
            .astype(np.float32).reshape(shape),
        )

    def render(self, r_c2w, t_c2w, right: bool = False,
               frame: int = 0) -> np.ndarray:
        return self.render_frame(r_c2w, t_c2w, right, frame)[0]

    def render_depth(self, r_c2w, t_c2w, frame: int = 0) -> np.ndarray:
        return self.render_frame(r_c2w, t_c2w, False, frame)[1]

    def stereo_sequence(self, n_frames: int, **kw):
        for f, (r, t) in enumerate(self.trajectory(n_frames, **kw)):
            yield (self.render(r, t, frame=f),
                   self.render(r, t, right=True, frame=f), (r, t))

    def rgbd_sequence(self, n_frames: int, **kw):
        for f, (r, t) in enumerate(self.trajectory(n_frames, **kw)):
            img, depth = self.render_frame(r, t, frame=f)
            yield img, depth, (r, t)


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """Absolute trajectory error (translation RMSE) without alignment —
    both trajectories share the first-frame anchor by construction."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=-1))))
