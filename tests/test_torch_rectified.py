"""lvt_tpu_torch's rectified stereo input (EuRoC: raw frames remapped
inside the step) against lvt_tpu, on the CPU.

The raw frames are rendered as tests/test_cli.py renders EuRoC frames
(``io.datasets.render_euroc_raw``, the port's copy): world points pushed
through each camera's rectifying rotation, distortion and K, the inverse
of the rectification the step applies. The JAX side runs as
the JAX tests run it on the CPU (patch mode, no MXU Hamming), with one
exception. After the remap the frames are non-integer float32. There
lvt_tpu's CPU path box-sums the image with cumulative sums, which round
otherwise than its Pallas kernel A; the two disagree in about 20% of a
rectified frame's descriptors (146 of 814 on frame 0 here). The port's
kernel A follows the Pallas kernel (ROADMAP H4), so where descriptors
matter the reference is lvt_tpu with kernel A in interpret mode
(``jx_kernel_a``). Tolerances:
  * the rectification maps: within 1e-4 px of lvt_tpu's (they come out
    bit-equal: the distortion runs op by op in float32 on both sides), and
    within 0.1 px of OpenCV's in the centre, as tests/test_io.py holds
    lvt_tpu's;
  * the remap: bit-equal to lvt_tpu's, on uint8 and non-integer frames
    (the port emulates the fused multiply-adds of XLA's CPU fusion);
  * frame 0's features from the remapped pair: keypoints, scores and
    validity bit-equal to lvt_tpu's CPU path; descriptors, scores and
    validity bit-equal to lvt_tpu with its kernel A, and keypoints at its
    valid slots (its Pallas path refines a few corners within 20 px of the
    right edge, all of them invalid, from the padding of its maps);
  * a rectified chunk of 6 frames through ``VOSystem(rectify_maps=...)``:
    per frame the same tracked map points, inliers and triangulated
    points as lvt_tpu with its kernel A, every pose within 1e-3 m (the
    bound test_torch_system.py gives the jitted JAX step; the gap grows
    from 6e-5 m at frame 1 to 6e-4 m at frame 5 on this sequence, and
    against lvt_tpu's CPU path to 1.0e-3 m), every frame TRACKING.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.config import VOConfig, load_config as jx_load_config
from lvt_tpu.core import extract as jx_extract
from lvt_tpu.core.system import VOSystem as JxVOSystem
from lvt_tpu.io import datasets as jx_datasets
from lvt_tpu.ops import perception_pallas as jx_pp
from lvt_tpu.ops import undistort as jx_undistort
from lvt_tpu_torch import configs, convert
from lvt_tpu_torch.core import extract, step
from lvt_tpu_torch.core.system import SensorType, TrackingState, VOSystem
from lvt_tpu_torch.io import datasets
from lvt_tpu_torch.ops import undistort
from tests.test_torch_system import share_the_cores  # noqa: F401

N_FRAMES = 6


@pytest.fixture
def jx_kernel_a(monkeypatch):
    """lvt_tpu's extraction with its Pallas kernel A (interpret mode on the
    CPU): a config switch for a VOConfig."""
    monkeypatch.setattr(jx_pp, "perception_patch_maps_batched",
                        functools.partial(jx_pp.perception_patch_maps_batched,
                                          interpret=True))
    return lambda cfg: cfg.replace(use_pallas_perception=True)


@pytest.fixture(scope="module")
def jx_maps():
    """lvt_tpu's two maps, as its EuRoC sequence reader builds them."""
    seq = jx_datasets.EurocSequence("unused", "MH_01_easy")
    return seq.map_l, seq.map_r


@pytest.fixture(scope="module")
def raw_sequence():
    """test_cli.py's EuRoC scene brought nearer (points 2-30 m away, where
    the rig's 0.11 m baseline triangulates well): 0.2 m per frame along
    the optical axis; raw uint8 left and right frames and the
    rectified-frame positions."""
    rs = np.random.RandomState(5)
    n_pts = 2500
    points = np.stack([rs.uniform(-15, 15, n_pts), rs.uniform(-8, 8, n_pts),
                       rs.uniform(2.0, 30.0, n_pts)], -1)
    intensities = rs.uniform(60.0, 215.0, n_pts)
    gt = [np.array([0.0, 0.0, 0.2 * i]) for i in range(N_FRAMES)]
    left = np.stack([datasets.render_euroc_raw(points, intensities, t, False)
                     for t in gt])
    right = np.stack([datasets.render_euroc_raw(points, intensities, t, True)
                      for t in gt])
    return left, right, np.array(gt)


def _config() -> VOConfig:
    """test_cli.py's EuRoC YAML at the rig's rectified camera, run as the
    JAX tests run lvt_tpu on the CPU."""
    w, h = jx_datasets.EUROC_SIZE
    p = jx_datasets.EUROC_P
    return VOConfig(
        fx=float(p[0, 0]), fy=float(p[1, 1]), cx=float(p[0, 2]),
        cy=float(p[1, 2]), baseline=jx_datasets.EUROC_BASELINE,
        img_width=w, img_height=h, near_plane_distance=0.5,
        far_plane_distance=100.0, agast_threshold=15,
        detection_cell_size=160, max_keypoints_per_cell=60,
        max_map_points=1024, max_staged_points=1024,
        descriptor_mode="patch", use_pallas_perception=False,
        use_pallas_matching=False, use_mxu_hamming=False)


def test_rectify_maps_match_lvt_tpu_and_opencv(jx_maps):
    import cv2

    ours = datasets.euroc_rectify_maps()
    w, h = datasets.EUROC_SIZE
    for got, want, k, d, r in zip(
            ours, jx_maps, (datasets.EUROC_KL, datasets.EUROC_KR),
            (datasets.EUROC_DL, datasets.EUROC_DR),
            (datasets.EUROC_RL, datasets.EUROC_RR)):
        assert got.shape == (h, w, 2) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        m1, m2 = cv2.initUndistortRectifyMap(k, d, r, datasets.EUROC_P,
                                             (w, h), cv2.CV_32FC1)
        sl = np.s_[100:380, 150:600]
        np.testing.assert_allclose(got[..., 0][sl], m1[sl], atol=0.1)
        np.testing.assert_allclose(got[..., 1][sl], m2[sl], atol=0.1)


@pytest.mark.parametrize("frames", ["uint8", "float32-fraction"])
def test_remap_matches_lvt_tpu(jx_maps, frames):
    rs = np.random.RandomState(1)
    w, h = datasets.EUROC_SIZE
    imgs = rs.randint(0, 256, (2, h, w)).astype(np.uint8)
    if frames != "uint8":
        imgs = imgs + rs.rand(2, h, w).astype(np.float32)
    maps = np.stack(jx_maps)
    # a map that also reads outside the image: the border clamp
    maps[1, :5] -= 40.0
    got = undistort.remap_bilinear(torch.from_numpy(imgs),
                                   torch.from_numpy(maps))
    for i in range(2):
        want = np.asarray(jx_undistort.remap_bilinear(jnp.asarray(imgs[i]),
                                                      jnp.asarray(maps[i])))
        np.testing.assert_array_equal(got[i].numpy(), want)
        one = undistort.remap_bilinear(torch.from_numpy(imgs[i]),
                                       torch.from_numpy(maps[i]))
        assert torch.equal(one, got[i])


def test_rectified_features_match_lvt_tpu(raw_sequence, jx_maps,
                                         jx_kernel_a):
    """Frame 0 remapped inside the step's rectify stage, then extracted:
    the remapped pair bit-equal to lvt_tpu's, and its features (float
    frames: kernel A's float path, no tie dither) as the module says."""
    left, right, _ = raw_sequence
    cfg = _config()
    maps = [torch.from_numpy(m) for m in jx_maps]
    rl, rr = step._rectify_pair(torch.from_numpy(left[0]),
                                torch.from_numpy(right[0]), *maps)
    jl, jr = (jx_undistort.remap_bilinear(jnp.asarray(x, jnp.float32),
                                          jnp.asarray(m))
              for x, m in ((left[0], jx_maps[0]), (right[0], jx_maps[1])))
    np.testing.assert_array_equal(rl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(rr.numpy(), np.asarray(jr))
    assert rl.dtype == torch.float32 and not extract._spread_ties(rl[None])
    feats = extract.extract_features_stereo(rl, rr, cfg)
    cpu_path = jx_extract.extract_features_stereo(jl, jr, cfg)
    kernel_a = jx_extract.extract_features_stereo(jl, jr, jx_kernel_a(cfg))
    for side, jc, ja in zip(feats, cpu_path, kernel_a):
        jc, ja = convert.to_port(jc, "cpu"), convert.to_port(ja, "cpu")
        for name in ("kp", "score", "valid"):
            assert torch.equal(getattr(side, name), getattr(jc, name)), name
        for name in ("desc", "score", "valid"):
            assert torch.equal(getattr(side, name), getattr(ja, name)), name
        assert torch.equal(side.kp[side.valid], ja.kp[side.valid])
        assert int(side.valid.sum()) > 500


def test_rectified_chunk_matches_lvt_tpu(raw_sequence, jx_maps,
                                        jx_kernel_a):
    left, right, gt = raw_sequence
    cfg = _config()
    vo = VOSystem(cfg, device="cpu", rectify_maps=jx_maps)
    assert all(m.device.type == "cpu" for m in vo.rectify_maps)
    poses, metrics = vo.track_chunk(left, right)
    jvo = JxVOSystem(jx_kernel_a(cfg), rectify_maps=jx_maps)
    jposes, jmetrics = jvo.track_chunk(left, right)
    np.testing.assert_allclose(poses.t.numpy(), np.asarray(jposes.t),
                               atol=1e-3)
    assert (metrics.status.numpy() == TrackingState.TRACKING).all()
    assert (np.asarray(jmetrics.status) == TrackingState.TRACKING).all()
    for name in ("tracked_map_points", "inlier_count", "triangulated_points"):
        np.testing.assert_array_equal(getattr(metrics, name).numpy(),
                                      np.asarray(getattr(jmetrics, name)),
                                      err_msg=name)
    # the rectified frame moves 1 m along its optical axis
    np.testing.assert_allclose(poses.t.numpy()[-1], gt[-1], atol=0.02)
    # one frame more through track: the same routing, a chunk of one
    pose = vo.track(left[0], right[0])
    assert torch.equal(pose.t, vo.last_pose.t)


def test_rectify_maps_are_checked():
    cfg = _config()
    m = np.zeros((cfg.img_height, cfg.img_width, 2), np.float32)
    with pytest.raises(ValueError, match="stereo"):
        VOSystem(cfg, SensorType.RGBD, device="cpu", rectify_maps=(m, m))
    with pytest.raises(ValueError, match="maps"):
        VOSystem(cfg, device="cpu", rectify_maps=(m, m[:-1]))


def test_euroc_config_is_lvt_tpus():
    """configs.euroc_config() is lvt_tpu's EuRoC entry point's config:
    the YAML configured with the rectified camera (EurocSequence
    .configure); 896 keypoint slots, 4096 map points, no staged points."""
    yaml = configs.EUROC_DIR + "/vo_config.yaml"
    seq = jx_datasets.EurocSequence.__new__(jx_datasets.EurocSequence)
    want = seq.configure(jx_load_config(yaml))
    ours = configs.euroc_config()
    assert dataclasses.asdict(ours) == dataclasses.asdict(want)
    assert (ours.kp_capacity, ours.max_map_points, ours.staged_threshold,
            ours.local_ba_window) == (896, 4096, 0, 0)
