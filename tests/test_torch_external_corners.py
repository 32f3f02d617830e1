"""lvt_tpu_torch's external-corner path (BRIEF at caller-supplied corners,
``VOSystem.track_with_external_corners``) against lvt_tpu, on the CPU.

The JAX side runs as the JAX tests run it on the CPU. Tolerances:
  * ``box_smooth`` on uint8 frames: bit-equal (every cumulative sum is an
    exact integer below 2^24). On non-integer float32 frames lvt_tpu's
    float32 cumsum rounds its partial sums otherwise than the port's
    (float64, rounded once per sum): within 4 units in the last place of
    the largest partial sum, 9 * 256 * (W + 9), measured 1 unit (0.125 at
    752x480);
  * ``descriptors_sparse``, ``compute_descriptors`` and
    ``describe_external_corners`` on uint8 frames: bit-equal, corners at
    and beyond the border and invalid slots included;
  * ``track_with_external_corners`` over 6 frames with the same corners
    (lvt_tpu's ``detect_corners``, as tests/test_end_to_end.py builds
    them): every pose within 1e-3 m of lvt_tpu's jitted step
    (test_torch_system.py's bound for it), both TRACKING, the same tracked
    map points per frame, and the ATE of tests/test_end_to_end.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.config import VOConfig
from lvt_tpu.core import extract as jx_extract
from lvt_tpu.core.system import VOSystem as JxVOSystem
from lvt_tpu.io.synthetic import SyntheticWorld, ate_rmse
from lvt_tpu.ops import brief as jx_brief
from lvt_tpu.ops import detect as jx_detect
from lvt_tpu_torch import convert
from lvt_tpu_torch.core import extract
from lvt_tpu_torch.core.system import TrackingState, VOSystem
from lvt_tpu_torch.ops import brief
from tests.test_torch_system import share_the_cores  # noqa: F401

SHAPES = [(376, 1241), (480, 752), (37, 53)]


def _corners(rs, h, w, k):
    """k corners over the image and 10 px beyond it, some on .5 (round
    half to even) and some exactly on the border lines; 20% invalid."""
    kp = np.stack([rs.uniform(-10, w + 10, k),
                   rs.uniform(-10, h + 10, k)], -1).astype(np.float32)
    kp[:8] = np.floor(kp[:8]) + 0.5
    kp[8:12] = [[20, 20], [w - 21, h - 21], [w - 20, 30], [30, h - 20]]
    return kp, rs.rand(k) > 0.2


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("frames", ["uint8", "float32-fraction"])
def test_box_smooth_matches_lvt_tpu(shape, frames):
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, shape).astype(np.uint8)
    if frames != "uint8":
        img = img + rs.rand(*shape).astype(np.float32)
    got = brief.box_smooth(torch.from_numpy(img)).numpy()
    want = np.asarray(jx_brief.box_smooth(jnp.asarray(img)))
    assert got.dtype == np.float32 and got.shape == shape
    if frames == "uint8":
        np.testing.assert_array_equal(got, want)
    else:
        ulp = np.spacing(np.float32(9 * 256 * (shape[1] + 9)))
        np.testing.assert_allclose(got, want, atol=4 * ulp, rtol=0)
    # a batch of images: each its own box sums
    both = brief.box_smooth(torch.from_numpy(np.stack([img, img[::-1]])))
    assert np.array_equal(both[0].numpy(), got)


@pytest.mark.parametrize("shape", SHAPES)
def test_descriptors_sparse_matches_lvt_tpu(shape):
    rs = np.random.RandomState(1)
    h, w = shape
    smooth = np.array(jx_brief.box_smooth(jnp.asarray(
        rs.randint(0, 256, shape).astype(np.uint8))))
    smooth[:, ::7] = 1234.0          # ties compare false
    kp, valid = _corners(rs, h, w, 300)
    got_d, got_v = brief.descriptors_sparse(
        torch.from_numpy(smooth), torch.from_numpy(kp),
        torch.from_numpy(valid))
    want_d, want_v = jx_brief.descriptors_sparse(
        jnp.asarray(smooth), jnp.asarray(kp), jnp.asarray(valid))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_d.numpy(),
                                  np.asarray(want_d).view(np.int32))
    assert got_d.dtype == torch.int32
    if min(shape) > 100:
        assert 100 < int(got_v.sum()) < int(valid.sum())


def test_compute_descriptors_matches_lvt_tpu():
    """uint8 frames, one at a time and as a batch of two."""
    rs = np.random.RandomState(2)
    h, w = 376, 1241
    imgs = rs.randint(0, 256, (2, h, w)).astype(np.uint8)
    kps, valids = zip(*(_corners(rs, h, w, 500) for _ in range(2)))
    got = brief.compute_descriptors(torch.from_numpy(imgs),
                                    torch.from_numpy(np.stack(kps)),
                                    torch.from_numpy(np.stack(valids)))
    for i in range(2):
        want_d, want_v = jx_brief.compute_descriptors(
            jnp.asarray(imgs[i]), jnp.asarray(kps[i]), jnp.asarray(valids[i]))
        np.testing.assert_array_equal(got[0][i].numpy(),
                                      np.asarray(want_d).view(np.int32))
        np.testing.assert_array_equal(got[1][i].numpy(), np.asarray(want_v))


def _world():
    return SyntheticWorld(width=320, height=240, fx=260.0, fy=260.0,
                          cx=160.0, cy=120.0, baseline=0.3, n_points=1500,
                          extent_x=40.0, extent_y=18.0, extent_z=90.0)


def _config(world) -> VOConfig:
    """tests/test_end_to_end.py's config, run as the JAX tests run lvt_tpu
    on the CPU."""
    return VOConfig(
        fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
        baseline=world.baseline, img_width=world.width,
        img_height=world.height, detection_cell_size=80,
        max_keypoints_per_cell=60, agast_threshold=15,
        near_plane_distance=0.5, far_plane_distance=150.0,
        max_map_points=1024, max_staged_points=1024,
        descriptor_mode="patch", use_pallas_perception=False,
        use_pallas_matching=False, use_mxu_hamming=False)


def _detect(img, cfg):
    """lvt_tpu's corners of an image, [N, 2] (tests/test_end_to_end.py)."""
    d = jx_detect.detect_corners(
        jnp.asarray(img, jnp.float32), cfg.agast_threshold,
        cell_size=cfg.detection_cell_size,
        max_per_cell=cfg.max_keypoints_per_cell)
    return np.asarray(d.kp)[np.asarray(d.valid)]


@pytest.fixture(scope="module")
def frames():
    world = _world()
    cfg = _config(world)
    out = []
    for left, right, (_, t) in world.stereo_sequence(6, speed=0.4):
        left, right = left.astype(np.uint8), right.astype(np.uint8)
        out.append((left, right, _detect(left, cfg), _detect(right, cfg), t))
    return cfg, out


def test_describe_external_corners_matches_lvt_tpu(frames):
    cfg, seq = frames
    left, _, corners, _, _ = seq[0]
    cap = cfg.kp_capacity
    n = len(corners)
    assert 0 < n < cap
    padded = np.zeros((cap, 2), np.float32)
    padded[:n] = corners
    valid = np.arange(cap) < n
    got = extract.describe_external_corners(
        torch.from_numpy(left), torch.from_numpy(padded),
        torch.from_numpy(valid), cfg)
    want = convert.to_port(jx_extract.describe_external_corners(
        jnp.asarray(left), jnp.asarray(padded), jnp.asarray(valid), cfg),
        "cpu")
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert int(got.valid.sum()) > 100


def test_track_with_external_corners_matches_lvt_tpu(frames):
    cfg, seq = frames
    vo, jvo = VOSystem(cfg, device="cpu"), JxVOSystem(cfg)
    est, jest, gt = [], [], []
    for left, right, cl, cr, t in seq:
        pose = vo.track_with_external_corners(left, right, cl, cr)
        jpose = jvo.track_with_external_corners(left, right, cl, cr)
        assert vo.get_state() == TrackingState.TRACKING
        assert int(jvo.state.status) == TrackingState.TRACKING
        assert int(vo.last_metrics.tracked_map_points) == int(
            jvo.last_metrics.tracked_map_points)
        assert torch.equal(pose.t, vo.last_pose.t)
        est.append(pose.t.numpy())
        jest.append(np.asarray(jpose.t))
        gt.append(t)
    np.testing.assert_allclose(np.array(est), np.array(jest), atol=1e-3)
    assert ate_rmse(np.array(est), np.array(gt)) < 0.2
    assert vo.frame_number == 6


def test_external_corners_are_padded_and_cut_to_capacity(frames):
    """Corners past kp_capacity are dropped, as lvt_tpu drops them; fewer
    corners leave the other slots invalid; a list works as an array."""
    cfg, seq = frames
    left, right, cl, cr, _ = seq[0]
    cfg = cfg.replace(max_keypoints_per_cell=20)    # kp_capacity 256
    cap = cfg.kp_capacity
    assert len(cl) > cap
    vo, jvo = VOSystem(cfg, device="cpu"), JxVOSystem(cfg)
    vo.track_with_external_corners(left, right, cl.tolist(), cr[:100])
    jvo.track_with_external_corners(left, right, cl, cr[:100])
    assert vo.map_size == jvo.map_size > 0
    np.testing.assert_array_equal(convert.to_numpy(vo.state).map.desc,
                                  np.asarray(jvo.state.map.desc))
