"""lvt_tpu_torch end to end against lvt_tpu: one step from the same state,
a short chunked sequence, the oracle's `fast` scenario, checkpoints in
both directions, the CLI, and the package's independence from JAX.

The JAX side runs as the JAX tests run it on the CPU, in patch mode with
the XLA paths (no Pallas kernels, no MXU Hamming). Tolerances:
  * one step from a JAX checkpoint: match_idx, feature_matched and
    matches_count equal; the new map's validity equal except at most 0.5%
    of slots, where a triangulation or chi-square gate sits on its float
    boundary; the pose within 1e-4 m of the JAX tracking step run op by
    op on the same (bit-equal) features under jax.disable_jit, and within
    1e-3 m of the jitted step with its own extraction. Jitted, XLA
    contracts products into fused multiply-adds inside its fusions, which
    moved this frame's pose by 1.1e-4 m against its own op-by-op run;
  * 8 chunked frames: every pose within 1e-3 m of the jitted JAX chunk,
    both TRACKING (the same rounding, carried from frame to frame);
  * 8 chunked frames in dense mode with local BA on (window 4, every 4
    frames; BA runs at frame 4): every pose within 2e-3 m of the jitted
    JAX chunk. On this sequence the jitted JAX chunk moves 1.37e-3 m from
    its own op-by-op run at frame 5, after the BA frame (the FMA
    contraction above, amplified by the BA solve), while the port stays
    within 1.1e-4 m of the op-by-op run at every frame;
  * `fast` scenario: the margins of test_parity_oracle.py.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.config import VOConfig
from lvt_tpu.core import extract as jx_extract
from lvt_tpu.core import step as jx_step
from lvt_tpu.core.motion import predict_next_pose as jx_predict
from lvt_tpu.core.step import _camera_kwargs as jx_camera_kwargs
from lvt_tpu.core.system import VOSystem as JxVOSystem
from lvt_tpu.io.synthetic import SyntheticWorld, ate_rmse
from lvt_tpu.io.trajectory import rot_rmse_deg, rpe_rmse
from lvt_tpu.ops import matching as jx_matching
from lvt_tpu_torch import convert
from lvt_tpu_torch.core import extract, step
from lvt_tpu_torch.core.motion import predict_next_pose
from lvt_tpu_torch.core.system import TrackingState, VOSystem
from lvt_tpu_torch.geometry import quaternion as quat
from lvt_tpu_torch.ops import matching
from lvt_tpu_torch.tree import flatten_with_path
from tools.oracle.scenarios import SCENARIOS

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN_DIR = REPO / "tests" / "golden"
K_FRAMES = 3       # frames tracked by JAX before the checkpoint
N_CHUNK = 8


@pytest.fixture(autouse=True, scope="module")
def share_the_cores():
    """Under pytest-xdist, torch in each worker would spin one thread per
    core beside the other workers: four 8-thread processes on 8 cores ran
    a 640x480 BA frame in 19 s, against 1.1 s with 2 threads each. Give
    torch the worker's share of the cores while a module runs. Imported by
    the other heavy tests/test_torch_*.py files."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
    yield
    torch.set_num_threads(before)


def _world():
    return SyntheticWorld(width=320, height=240, fx=260.0, fy=260.0,
                          cx=160.0, cy=120.0, baseline=0.3, n_points=1500,
                          extent_x=40.0, extent_y=18.0, extent_z=90.0)


def _config(world) -> VOConfig:
    return VOConfig(
        fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
        baseline=world.baseline, img_width=world.width,
        img_height=world.height, detection_cell_size=80,
        max_keypoints_per_cell=60, agast_threshold=15,
        near_plane_distance=0.5, far_plane_distance=150.0,
        max_map_points=1024, max_staged_points=1024,
        descriptor_mode="patch", use_pallas_perception=False,
        use_pallas_matching=False, use_mxu_hamming=False)


@pytest.fixture(scope="module")
def sequence():
    world = _world()
    frames = [(l.astype(np.uint8), r.astype(np.uint8), t)
              for l, r, (_, t) in world.stereo_sequence(N_CHUNK, speed=0.5)]
    return _config(world), frames


@pytest.fixture(scope="module")
def jax_checkpoint(sequence, tmp_path_factory):
    cfg, frames = sequence
    vo = JxVOSystem(cfg)
    for left, right, _ in frames[:K_FRAMES]:
        vo.track(left, right)
    path = tmp_path_factory.mktemp("ckpt") / "jax_state.npz"
    vo.save_checkpoint(str(path))
    return vo, path


def test_one_step_from_jax_checkpoint(sequence, jax_checkpoint):
    cfg, frames = sequence
    jvo, path = jax_checkpoint
    vo = VOSystem(cfg, device="cpu")
    vo.load_checkpoint(str(path))
    assert vo.get_state() == TrackingState.TRACKING
    left_img, right_img, _ = frames[K_FRAMES]

    # map matching of frame k+1 from the same state
    feats = extract.extract_features_stereo(
        torch.from_numpy(left_img), torch.from_numpy(right_img), cfg)
    jfeats = jx_extract.extract_features_stereo(
        jnp.asarray(left_img), jnp.asarray(right_img), cfg)
    for side, jside in zip(feats, jfeats):
        for a, b in zip(side, convert.to_port(jside, "cpu")):
            assert torch.equal(a, b)
    left, jleft = feats[0], jfeats[0]
    kw = dict(tracking_radius=cfg.tracking_radius,
              ratio_threshold=cfg.tracking_ratio_test_threshold,
              abs_threshold=cfg.descriptor_matching_threshold,
              retry_min_matches=cfg.n_matches_threshold)
    _, predicted = predict_next_pose(vo.state.motion, vo.state.pose)
    mm = matching.find_map_matches(
        vo.state.map.pos, vo.state.map.desc, vo.state.map.valid, predicted,
        left, **kw, **step._camera_kwargs(cfg))
    js = jvo.state
    _, jpredicted = jx_predict(js.motion, js.pose)
    jmm = jx_matching.find_map_matches(
        js.map.pos, js.map.desc, js.map.valid, jpredicted, jleft, **kw,
        **jx_camera_kwargs(cfg))
    for name in ("match_idx", "feature_matched", "matches_count"):
        np.testing.assert_array_equal(getattr(mm, name).numpy(),
                                      np.asarray(getattr(jmm, name)),
                                      err_msg=name)
    assert int(mm.matches_count) > 100

    # the whole step, against JAX op by op and jitted
    pose = vo.track(left_img, right_img)
    with jax.disable_jit():
        eager = jx_step.track_features(js, *jfeats, cfg, rgbd=False)
    jpose = jvo.track(left_img, right_img)
    jitted = (jvo.state, jpose, jvo.last_metrics)
    valid = vo.state.map.valid.numpy()
    for (state, ref_pose, metrics), atol in ((eager, 1e-4), (jitted, 1e-3)):
        assert (valid != np.asarray(state.map.valid)).mean() <= 0.005
        np.testing.assert_allclose(pose.t.numpy(), np.asarray(ref_pose.t),
                                   atol=atol)
        np.testing.assert_allclose(pose.q.numpy(), np.asarray(ref_pose.q),
                                   atol=atol)
        for name in ("tracked_map_points", "inlier_count"):
            assert int(getattr(vo.last_metrics, name)) == int(
                getattr(metrics, name)), name


def test_checkpoint_round_trip_both_ways(sequence, jax_checkpoint, tmp_path):
    """A JAX checkpoint loads into the port and comes back out with the
    same keys, dtypes and values; the port's loads into JAX."""
    cfg, _ = sequence
    _, path = jax_checkpoint
    vo = VOSystem(cfg, device="cpu")
    vo.load_checkpoint(str(path))
    out = tmp_path / "port_state.npz"
    vo.save_checkpoint(str(out))
    a, b = np.load(path), np.load(out)
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert a[".map.desc"].dtype == np.uint32
    jvo = JxVOSystem(cfg)
    jvo.load_checkpoint(str(out))
    assert int(jvo.state.status) == int(vo.state.status)
    assert jvo.map_size == vo.map_size > 0


def test_positional_checkpoint_of_lvt_tpu_loads(sequence, jax_checkpoint,
                                                tmp_path):
    """lvt_tpu's older positional format: its state's leaves, in its leaf
    order, saved as np.savez's arr_0, arr_1, ... (lvt_tpu loads such a
    file itself). The port loads it into the same state as the path-keyed
    file, and refuses one with a leaf missing."""
    cfg, _ = sequence
    _, path = jax_checkpoint
    jvo = JxVOSystem(cfg)
    jvo.load_checkpoint(str(path))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jvo.state)]
    legacy = tmp_path / "positional.npz"
    np.savez(legacy, *leaves)
    assert np.load(legacy).files[:2] == ["arr_0", "arr_1"]
    JxVOSystem(cfg).load_checkpoint(str(legacy))
    keyed, positional = VOSystem(cfg, device="cpu"), VOSystem(cfg, device="cpu")
    keyed.load_checkpoint(str(path))
    positional.load_checkpoint(str(legacy))
    pairs = list(zip(flatten_with_path(keyed.state),
                     flatten_with_path(positional.state)))
    assert len(pairs) == len(leaves)
    for (key, a), (_, b) in pairs:
        assert a.dtype == b.dtype and torch.equal(a, b), key
    assert positional.get_state() == TrackingState.TRACKING
    short = tmp_path / "short.npz"
    np.savez(short, *leaves[:-1])
    with pytest.raises(ValueError, match="positional"):
        VOSystem(cfg, device="cpu").load_checkpoint(str(short))


def test_last_pose_reads_as_lvt_tpus_callers_read_it(sequence,
                                                     jax_checkpoint):
    """``last_pose`` as lvt_tpu's C ABI and frame dumper read it
    (``pose_to_numpy(vo.last_pose)``, ``np.asarray(vo.last_pose.t)``): the
    checkpointed pose after a load, the returned pose after a track."""
    cfg, frames = sequence
    _, path = jax_checkpoint
    vo = VOSystem(cfg, device="cpu")
    vo.load_checkpoint(str(path))
    data = np.load(path)
    np.testing.assert_array_equal(np.asarray(vo.last_pose.t), data[".pose.t"])
    np.testing.assert_array_equal(np.asarray(vo.last_pose.q), data[".pose.q"])
    rot = np.asarray(quat.to_matrix(vo.last_pose.q))
    assert rot.shape == (3, 3)
    np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-5)
    pose = vo.track(frames[K_FRAMES][0], frames[K_FRAMES][1])
    assert torch.equal(vo.last_pose.t, pose.t)
    assert torch.equal(vo.last_pose.q, pose.q)


def test_chunked_sequence_matches_lvt_tpu(sequence):
    cfg, frames = sequence
    il = np.stack([f[0] for f in frames])
    ir = np.stack([f[1] for f in frames])
    vo = VOSystem(cfg, device="cpu")
    poses, metrics = vo.track_chunk(il, ir)
    jvo = JxVOSystem(cfg)
    jposes, jmetrics = jvo.track_chunk(il, ir)
    np.testing.assert_allclose(poses.t.numpy(), np.asarray(jposes.t),
                               atol=1e-3)
    assert vo.get_state() == TrackingState.TRACKING
    assert int(jvo.state.status) == TrackingState.TRACKING
    assert (metrics.status.numpy() == TrackingState.TRACKING).all()
    # and both followed the ground truth
    gt = np.array([f[2] for f in frames])
    assert ate_rmse(poses.t.numpy(), gt) < 0.05 * np.linalg.norm(gt[-1] - gt[0])


def test_chunked_ba_dense_sequence_matches_lvt_tpu(sequence):
    cfg, frames = sequence
    cfg = cfg.replace(descriptor_mode="dense", local_ba_window=4,
                      local_ba_every=4)
    il = np.stack([f[0] for f in frames])
    ir = np.stack([f[1] for f in frames])
    vo = VOSystem(cfg, device="cpu")
    poses, metrics = vo.track_chunk(il, ir)
    jvo = JxVOSystem(cfg)
    jposes, _ = jvo.track_chunk(il, ir)
    np.testing.assert_array_equal(metrics.local_ba_ran.numpy(),
                                  np.arange(N_CHUNK) == 4)
    np.testing.assert_allclose(poses.t.numpy(), np.asarray(jposes.t),
                               atol=2e-3)
    assert vo.get_state() == TrackingState.TRACKING
    assert int(jvo.state.status) == TrackingState.TRACKING
    np.testing.assert_array_equal(vo.state.ba.w.numpy() > 0,
                                  np.asarray(jvo.state.ba.w) > 0)
    gt = np.array([f[2] for f in frames])
    assert ate_rmse(poses.t.numpy(), gt) < 0.05 * np.linalg.norm(gt[-1] - gt[0])


def test_track_chunk_equals_per_frame_track(sequence):
    cfg, frames = sequence
    a = VOSystem.create(cfg, device="cpu")
    poses, _ = a.track_chunk(np.stack([f[0] for f in frames[:4]]),
                             np.stack([f[1] for f in frames[:4]]))
    b = VOSystem(cfg, device="cpu")
    for i, (left, right, _) in enumerate(frames[:4]):
        p = b.track(left, right)
        assert torch.equal(p.t, poses.t[i]) and torch.equal(p.q, poses.q[i])
    assert b.frame_number == 4
    b.reset()
    assert b.get_state() == TrackingState.NOT_INITIALIZED
    assert b.map_size == 0 and b.last_metrics is None


def test_fast_scenario_within_oracle_margin():
    """The port over the oracle's `fast` scenario, held to the margins of
    tests/test_parity_oracle.py::test_trajectory_within_oracle_margin."""
    sc = next(s for s in SCENARIOS if s.name == "fast")
    golden = np.load(GOLDEN_DIR / f"{sc.name}.npz")
    assert int(golden["n_frames"]) == sc.n_frames
    world = sc.world()
    vo = VOSystem(VOConfig(
        fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
        baseline=world.baseline, img_width=world.width,
        img_height=world.height, **dict(sc.vo_overrides)), device="cpu")
    est, est_r, gt, gt_r = [], [], [], []
    for a, b, (r, t) in sc.frames():
        pose = vo.track(a, b)
        est.append(pose.t.numpy())
        est_r.append(quat.to_matrix(pose.q).numpy())
        gt.append(t)
        gt_r.append(r)
    est, gt = np.array(est), np.array(gt)
    checks = [
        ("ATE", ate_rmse(est, gt), float(golden["ate"]), sc.abs_margin),
        ("RPE(1)", rpe_rmse(est, gt), float(golden["rpe"]), sc.rpe_abs_margin),
        ("rot", rot_rmse_deg(np.array(est_r), np.array(gt_r)),
         float(golden["rot"]), sc.rot_abs_margin),
    ]
    failures = [f"{name}: {ours:.4f} > {oracle * sc.rel_margin + abs_m:.4f}"
                for name, ours, oracle, abs_m in checks
                if ours > oracle * sc.rel_margin + abs_m]
    assert not failures, failures
    assert vo.get_state() == TrackingState.TRACKING


def test_package_imports_no_jax():
    code = ("import sys, lvt_tpu_torch, lvt_tpu_torch.core.system, "
            "lvt_tpu_torch.__main__; assert 'jax' not in sys.modules, "
            "sorted(m for m in sys.modules if m.startswith('jax'))")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_cli_synthetic_runs_on_the_cpu(capsys):
    from lvt_tpu_torch.__main__ import main

    assert main(["synthetic", "--frames", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "ATE RMSE" in out and "TRACKING" in out


def test_cuda_device_without_cuda_fails_loudly(monkeypatch):
    """No silent fallback to the CPU: asking for CUDA without it raises."""
    from lvt_tpu_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["synthetic", "--frames", "1"])          # default --device cuda
    with pytest.raises(RuntimeError, match="cuda"):
        VOSystem(_config(_world()), device="cuda")


def test_unported_options_raise():
    """Every option of lvt_tpu is ported: VOSystem and MultiStreamVO take
    the sparse descriptor mode (tests/test_torch_sparse.py holds it
    against lvt_tpu), the RGB-D sensor is ported
    (tests/test_torch_rgbd.py), and a sensor that does not exist
    raises."""
    from lvt_tpu_torch.parallel.multistream import MultiStreamVO

    cfg = _config(_world())
    sparse = cfg.replace(descriptor_mode="sparse")
    assert VOSystem(sparse, device="cpu").config is sparse
    assert MultiStreamVO(sparse, 2, device="cpu").config is sparse
    with pytest.raises(ValueError):
        VOSystem(cfg, sensor_type=3, device="cpu")
    assert VOSystem(cfg, sensor_type=2, device="cpu").sensor_type == 2
