"""lvt_tpu_torch's RGB-D sensor against lvt_tpu on the CPU: undistortion,
back-projection, extraction, the tracking chunk, the oracle's RGB-D
scenarios, and the multi-stream RGB-D step.

The JAX side runs as the JAX tests run it on the CPU (patch mode through
XLA, no Pallas kernels, no MXU Hamming). Tolerances:
  * ``undistort_points`` and ``undistorted_image_bounds`` at the TUM
    YAMLs' coefficients: within 1e-4 px (8 fixed-point iterations in
    float32 on both sides); ``distort_normalized`` within 1e-6;
  * ``backproject_rgbd``: within 1e-6 relative;
  * ``extract_features_rgbd`` at the TUM fr1 YAML (k1 = 0.262, one cell
    of 1000 corners) on a 640x480 synthetic gray and depth pair: ``valid``,
    ``desc`` and ``depth`` equal, ``kp`` within 1e-4 px;
  * ``track_chunk_rgbd`` over 8 frames of tests/test_parallel.py's 192x144
    world: every pose within 1e-3 m of the jitted JAX chunk (its fused
    multiply-adds, test_torch_system.py), statuses and match counts equal;
  * the `rgbd` and `tex_rgbd` scenarios: the margins of
    tests/test_parity_oracle.py;
  * the multi-stream RGB-D step at S = 2 (two worlds): every pose within
    1e-4 m of the port's single-stream RGB-D run of the same stream.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu import config as jx_config
from lvt_tpu.core import extract as jx_extract
from lvt_tpu.core.system import SensorType as JxSensorType
from lvt_tpu.core.system import VOSystem as JxVOSystem
from lvt_tpu.geometry.se3 import Pose as JxPose
from lvt_tpu.io.synthetic import SyntheticWorld, ate_rmse
from lvt_tpu.io.trajectory import rot_rmse_deg, rpe_rmse
from lvt_tpu.ops import triangulate as jx_triangulate
from lvt_tpu.ops import undistort as jx_undistort
from lvt_tpu_torch import configs, convert
from lvt_tpu_torch.core import extract
from lvt_tpu_torch.core.state import TRACKING
from lvt_tpu_torch.core.system import SensorType, TrackingState, VOSystem
from lvt_tpu_torch.geometry import quaternion as quat
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.ops import triangulate, undistort
from lvt_tpu_torch.parallel import multistream as ms
from tests.test_torch_multistream import WORLD, _config, _u8
from tests.test_torch_system import share_the_cores  # noqa: F401
from tools.oracle.scenarios import SCENARIOS

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN_DIR = REPO / "tests" / "golden"
JX_TUM = REPO / "lvt_tpu" / "configs" / "tum_rgbd"
DIST = ("k1", "k2", "p1", "p2", "k3")


def _tum(freiburg):
    return configs.tum_rgbd_config(freiburg)


@pytest.mark.parametrize("freiburg", [1, 2, 3])
def test_undistortion_matches_lvt_tpu(freiburg):
    cfg = _tum(freiburg)
    cam = [cfg.fx, cfg.fy, cfg.cx, cfg.cy] + [getattr(cfg, k) for k in DIST]
    rs = np.random.RandomState(freiburg)
    pts = np.concatenate([
        rs.uniform(0, [640, 480], (500, 2)),
        [[0, 0], [640, 0], [0, 480], [640, 480]]]).astype(np.float32)
    got = undistort.undistort_points(torch.from_numpy(pts), *cam).numpy()
    want = np.asarray(jx_undistort.undistort_points(jnp.asarray(pts), *cam))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if abs(cfg.k1) > 1e-5:                       # fr1, fr2: distorted
        assert np.abs(got - pts).max() > 5.0
    bounds = undistort.undistorted_image_bounds(640, 480, *cam)
    assert all(type(b) is float for b in bounds)
    np.testing.assert_allclose(
        bounds, jx_undistort.undistorted_image_bounds(640, 480, *cam),
        atol=1e-4, rtol=0)
    xy = rs.uniform(-0.6, 0.6, (300, 2)).astype(np.float32)
    np.testing.assert_allclose(
        undistort.distort_normalized(torch.from_numpy(xy), *cam[4:]).numpy(),
        np.asarray(jx_undistort.distort_normalized(jnp.asarray(xy),
                                                   *cam[4:])),
        atol=1e-6, rtol=0)
    # no distortion: the image itself
    assert undistort.undistorted_image_bounds(
        640, 480, *cam[:4], 0.0, 0.0, 0.0, 0.0, 0.0) == (0.0, 640.0, 0.0, 480.0)


def test_backproject_rgbd_matches_lvt_tpu():
    cfg = _tum(1)
    rs = np.random.RandomState(7)
    uv = rs.uniform(0, [640, 480], (400, 2)).astype(np.float32)
    depth = rs.uniform(0.1, 5.0, 400).astype(np.float32)
    valid = rs.rand(400) > 0.2
    t = rs.randn(3).astype(np.float32)
    q = rs.randn(4).astype(np.float32)
    q /= np.linalg.norm(q)
    cam = dict(fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy)
    got = triangulate.backproject_rgbd(
        torch.from_numpy(uv), torch.from_numpy(depth),
        torch.from_numpy(valid), Pose(torch.from_numpy(t),
                                      torch.from_numpy(q)), **cam)
    want = jx_triangulate.backproject_rgbd(
        jnp.asarray(uv), jnp.asarray(depth), jnp.asarray(valid),
        JxPose(jnp.asarray(t), jnp.asarray(q)), **cam)
    # relative to each point's distance (a world coordinate near 0 keeps
    # the rounding of the others)
    for a, b in zip(got[:2], want[:2]):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max(-1)
        assert (err <= 1e-6 * np.linalg.norm(b, axis=-1)).all(), err.max()
    np.testing.assert_array_equal(got.valid.numpy(), valid)


def test_extract_features_rgbd_matches_lvt_tpu():
    """At the TUM fr1 YAML, with its distortion on."""
    cfg = _tum(1)
    jcfg = jx_config.load_config(
        str(JX_TUM / "config_tum1.yaml"), descriptor_mode="patch",
        use_pallas_perception=False, use_pallas_matching=False,
        use_mxu_hamming=False)
    assert cfg.kp_capacity == jcfg.kp_capacity == 1024 and cfg.k1 > 0.2
    # points 2-6 m away, the range of a TUM depth camera (far plane 5 m)
    (gray, depth, _), = SyntheticWorld(
        fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy, extent_x=4.0,
        extent_y=3.0, extent_z=6.0).rgbd_sequence(1)
    gray, depth = _u8(gray), depth.astype(np.float32)
    got = extract.extract_features_rgbd(torch.from_numpy(gray),
                                        torch.from_numpy(depth), cfg)
    want = convert.to_port(jx_extract.extract_features_rgbd(
        jnp.asarray(gray), jnp.asarray(depth), jcfg), "cpu")
    for name in ("valid", "desc", "depth", "score"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    torch.testing.assert_close(got.kp, want.kp, atol=1e-4, rtol=0)
    n = int(got.valid.sum())
    assert 100 < n < int(extract.extract_features(
        torch.from_numpy(gray), cfg).valid.sum())   # depth cleared some


def _rgbd_frames(world, n, **kw):
    seq = list(world.rgbd_sequence(n, **kw))
    return (np.stack([_u8(g) for g, _, _ in seq]),
            np.stack([d.astype(np.float32) for _, d, _ in seq]),
            np.array([t for _, _, (_, t) in seq]))


def test_track_chunk_rgbd_matches_lvt_tpu():
    cfg = _config(triangulation_policy=2)
    gray, depth, _ = _rgbd_frames(SyntheticWorld(**WORLD), 8, speed=0.3)
    vo = VOSystem(cfg, SensorType.RGBD, device="cpu")
    poses, metrics = vo.track_chunk(gray, depth)
    jvo = JxVOSystem(cfg, JxSensorType.RGBD)
    jposes, jmetrics = jvo.track_chunk(gray, depth)
    np.testing.assert_allclose(poses.t.numpy(), np.asarray(jposes.t),
                               atol=1e-3, rtol=0)
    for name in ("status", "tracked_map_points"):
        np.testing.assert_array_equal(getattr(metrics, name).numpy(),
                                      np.asarray(getattr(jmetrics, name)))
    assert (metrics.status.numpy() == TRACKING).all()
    assert (metrics.tracked_map_points.numpy()[1:] > 100).all()
    # one track() call per frame gives the chunk's poses
    b = VOSystem.create(cfg, SensorType.RGBD, device="cpu")
    for i in range(3):
        assert torch.equal(b.track(gray[i], depth[i]).t, poses.t[i])


@pytest.mark.parametrize("name", ["rgbd", "tex_rgbd"])
def test_rgbd_scenario_within_oracle_margin(name):
    """The port's RGB-D path over the oracle's RGB-D scenarios (the blob
    world, and the textured corridor), held to the margins of
    tests/test_parity_oracle.py."""
    sc = next(s for s in SCENARIOS if s.name == name)
    golden = np.load(GOLDEN_DIR / f"{sc.name}.npz")
    assert int(golden["n_frames"]) == sc.n_frames and sc.sensor == "rgbd"
    world = sc.world()
    vo = VOSystem(jx_config.VOConfig(
        fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
        baseline=world.baseline, img_width=world.width,
        img_height=world.height, **dict(sc.vo_overrides)),
        SensorType.RGBD, device="cpu")
    frames = list(sc.frames())
    poses, _ = vo.track_chunk(np.stack([a for a, _, _ in frames]),
                              np.stack([b for _, b, _ in frames]))
    est = poses.t.numpy()
    est_r = quat.to_matrix(poses.q).numpy()
    gt = np.array([t for _, _, (_, t) in frames])
    gt_r = np.array([r for _, _, (r, _) in frames])
    checks = [
        ("ATE", ate_rmse(est, gt), float(golden["ate"]), sc.abs_margin),
        ("RPE(1)", rpe_rmse(est, gt), float(golden["rpe"]), sc.rpe_abs_margin),
        ("rot", rot_rmse_deg(est_r, gt_r), float(golden["rot"]),
         sc.rot_abs_margin),
    ]
    failures = [f"{name}: {ours:.4f} > {oracle * sc.rel_margin + abs_m:.4f}"
                for name, ours, oracle, abs_m in checks
                if ours > oracle * sc.rel_margin + abs_m]
    assert not failures, failures
    assert vo.get_state() == TrackingState.TRACKING


def test_multistream_rgbd_matches_single_stream():
    cfg = _config(triangulation_policy=2)
    a = _rgbd_frames(SyntheticWorld(**WORLD), 6, speed=0.3)
    b = _rgbd_frames(SyntheticWorld(**dict(WORLD, seed=99)), 6, speed=0.45,
                     yaw_rate=0.01)
    gray = np.stack([a[0], b[0]], axis=1)       # [N, S, H, W]
    depth = np.stack([a[1], b[1]], axis=1)
    msvo = ms.MultiStreamVO(cfg, 2, device="cpu", rgbd=True)
    poses, metrics = msvo.track_chunk(gray, depth)
    assert (msvo.status == TRACKING).all()
    for s in range(2):
        vo = VOSystem(cfg, SensorType.RGBD, device="cpu")
        p, m = vo.track_chunk(gray[:, s], depth[:, s])
        np.testing.assert_allclose(poses.t[:, s].numpy(), p.t.numpy(),
                                   atol=1e-4, rtol=0)
        np.testing.assert_array_equal(metrics.status[:, s].numpy(),
                                      m.status.numpy())
    assert float((poses.t[-1, 0] - poses.t[-1, 1]).norm()) > 0.1

