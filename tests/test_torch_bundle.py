"""lvt_tpu_torch's windowed bundle adjustment against lvt_tpu: the solver
functions on the seeded windows of tests/test_bundle.py, one BA step from
a JAX checkpoint, and BA's effect on the `noisy_ba` golden scenario.

Tolerances (the port sums in float64 and rounds once, lvt_tpu sums in
float32 in XLA's order; the Schur solve amplifies that rounding):
  * chi2_gate_weights: equal; weighted_point_e2: within 1e-6 relative;
  * refine_window: poses within 1e-4 m (quaternions 1e-5), points within
    1e-2 m over 8-30 m depths, robust chi2 within 1e-5 relative + 1e-5.
    The monocular window leaves scale free, so there both must only fit
    (chi2 < 1e-3), as tests/test_bundle.py asks of lvt_tpu;
  * one step with BA from a JAX checkpoint, against the jitted JAX step:
    the window's observations equal, its poses and the pose within 1e-3 m
    (XLA contracts products into FMAs inside its fusions: jitted JAX moved
    1.37e-3 m from its own op-by-op run on a BA frame of this sequence,
    where the port stayed within 1.1e-4 m of the op-by-op run), the BA
    writeback test ``e2_new <= e2_old`` decided alike for all but 1% of
    the refined points (each decision sits on a float comparison; 0 flips
    measured), and points refined by both within 1e-2 m;
  * `noisy_ba`: the margins of tests/test_parity_oracle.py, and the ATE
    with BA strictly below the port's own ATE with BA off on the same
    frames.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.config import VOConfig
from lvt_tpu.core.system import VOSystem as JxVOSystem
from lvt_tpu.geometry.se3 import Pose as JxPose
from lvt_tpu.io.synthetic import SyntheticWorld, ate_rmse
from lvt_tpu.io.trajectory import rot_rmse_deg, rpe_rmse
from lvt_tpu.solver import bundle as jx_bundle
from lvt_tpu_torch import convert
from lvt_tpu_torch.core.system import TrackingState, VOSystem
from lvt_tpu_torch.geometry import quaternion as quat
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.solver import bundle
from lvt_tpu_torch.tree import flatten_with_path
from test_bundle import BASELINE, K, make_ba_problem
from test_torch_system import share_the_cores  # noqa: F401
from tools.oracle.scenarios import SCENARIOS

GOLDEN_DIR = pathlib.Path(__file__).resolve().parent / "golden"


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _pose(p: JxPose) -> Pose:
    return Pose(_t(p.t), _t(p.q))


@pytest.mark.parametrize("case", ["exact", "noisy", "outliers", "masked",
                                  "mono"])
def test_refine_window_matches_lvt_tpu(case):
    rng = np.random.RandomState(42)
    noise = {"noisy": 0.5, "outliers": 0.2}.get(case, 0.0)
    poses_gt, _, poses_n, pts_n, obs, obs_r, w = make_ba_problem(
        rng, pixel_noise=noise)
    obs, w = np.asarray(obs).copy(), np.asarray(w).copy()
    if case == "outliers":
        obs[:, :20] += 120.0
    if case == "masked":
        obs[:, :50] = 1e5
        w[:, :50] = 0.0
    iters = {"noisy": 6, "masked": 8, "mono": 10}.get(case, 12)
    kw = dict(**K, iterations=iters)
    jkw, tkw = dict(kw), dict(kw)
    if case != "mono":
        jkw.update(baseline=BASELINE, obs_right=obs_r, w_right=w)
        tkw.update(baseline=BASELINE, obs_right=_t(obs_r), w_right=_t(w))
    ref = jx_bundle.refine_window(poses_n, pts_n, jnp.asarray(obs),
                                  jnp.asarray(w), **jkw)
    got = bundle.refine_window(_pose(poses_n), _t(pts_n), _t(obs), _t(w),
                               **tkw)
    assert int(got.n_obs) == int(ref.n_obs)
    if case == "mono":   # free scale: both must fit the observations
        assert float(got.chi2) < 1e-3 and float(ref.chi2) < 1e-3
        return
    np.testing.assert_allclose(got.poses.t.numpy(), np.asarray(ref.poses.t),
                               atol=1e-4)
    np.testing.assert_allclose(got.poses.q.numpy(), np.asarray(ref.poses.q),
                               atol=1e-5)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points),
                               atol=1e-2)
    np.testing.assert_allclose(float(got.chi2), float(ref.chi2), rtol=1e-5,
                               atol=1e-5)
    if case == "masked":   # no update force on the masked points
        assert torch.equal(got.points[:50], _t(pts_n)[:50])


def test_gate_and_point_e2_match_lvt_tpu():
    rng = np.random.RandomState(42)
    poses_gt, pts, _, pts_n, obs, obs_r, w = make_ba_problem(
        rng, pixel_noise=2.0)
    f, m = obs.shape[:2]
    bad = rng.rand(f, m) < 0.10          # mismatch-sized errors, 6-40 px
    obs = (np.asarray(obs) + bad[..., None] * rng.uniform(6, 40, (f, m, 2))
           ).astype(np.float32)
    jkw = dict(**K, baseline=BASELINE, obs_right=obs_r, w_right=w)
    tkw = dict(**K, baseline=BASELINE, obs_right=_t(obs_r), w_right=_t(w))
    got = bundle.chi2_gate_weights(_pose(poses_gt), _t(pts), _t(obs), _t(w),
                                   **tkw)
    ref = jx_bundle.chi2_gate_weights(poses_gt, pts, jnp.asarray(obs), w,
                                      **jkw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert 0.8 * w.size < float(got[0].sum()) < w.size
    e2 = bundle.weighted_point_e2(_pose(poses_gt), _t(pts_n), _t(obs), _t(w),
                                  **tkw)
    want = jx_bundle.weighted_point_e2(poses_gt, pts_n, jnp.asarray(obs), w,
                                       **jkw)
    np.testing.assert_allclose(e2.numpy(), np.asarray(want), rtol=1e-6)


def _ba_config(world, **kw) -> VOConfig:
    return VOConfig(
        fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
        baseline=world.baseline, img_width=world.width,
        img_height=world.height, detection_cell_size=80,
        max_keypoints_per_cell=60, agast_threshold=15,
        near_plane_distance=0.5, far_plane_distance=150.0,
        max_map_points=1024, max_staged_points=1024,
        local_ba_window=4, local_ba_every=4, use_pallas_perception=False,
        use_pallas_matching=False, use_mxu_hamming=False, **kw)


def test_one_ba_step_from_jax_checkpoint(tmp_path):
    """JAX tracks frames 0-3 (the window then holds 3 frames), the port and
    JAX each track frame 4 from that state: the window fills and BA runs."""
    world = SyntheticWorld(width=320, height=240, fx=260.0, fy=260.0,
                           cx=160.0, cy=120.0, baseline=0.3, n_points=1500,
                           extent_x=40.0, extent_y=18.0, extent_z=90.0)
    cfg = _ba_config(world, descriptor_mode="patch")
    frames = [(l.astype(np.uint8), r.astype(np.uint8))
              for l, r, _ in world.stereo_sequence(5, speed=0.5)]
    jvo = JxVOSystem(cfg)
    for left, right in frames[:4]:
        jvo.track(left, right)
    path = tmp_path / "ba_state.npz"
    jvo.save_checkpoint(str(path))
    before = np.asarray(jvo.state.map.pos)
    valid_before = np.asarray(jvo.state.map.valid)
    assert int(jvo.state.ba.n) == 3 and int(jvo.state.frame_number) == 4

    vo = VOSystem(cfg, device="cpu")
    vo.load_checkpoint(str(path))
    pose = vo.track(*frames[4])
    jpose = jvo.track(*frames[4])
    assert bool(vo.last_metrics.local_ba_ran)
    js, ps = jvo.state, vo.state
    for name in ("obs", "w", "obs_r", "w_r", "n"):
        np.testing.assert_array_equal(getattr(ps.ba, name).numpy(),
                                      np.asarray(getattr(js.ba, name)), name)
    np.testing.assert_allclose(ps.ba.poses_t.numpy(), np.asarray(js.ba.poses_t),
                               atol=1e-3)
    np.testing.assert_allclose(pose.t.numpy(), np.asarray(jpose.t), atol=1e-3)

    valid = ps.map.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(js.map.valid))
    old = valid & valid_before
    moved_p = (ps.map.pos.numpy() != before).any(1) & old
    moved_j = (np.asarray(js.map.pos) != before).any(1) & old
    assert moved_j.sum() > 100
    flips = int((moved_p != moved_j).sum())
    assert flips <= 0.01 * moved_j.sum(), flips
    both = moved_p & moved_j
    np.testing.assert_allclose(ps.map.pos.numpy()[both],
                               np.asarray(js.map.pos)[both], atol=1e-2)


def test_ba_lowers_ate_on_noisy_ba():
    """The port over the `noisy_ba` golden frames with BA on (the
    scenario's window of 4, every 4 frames) stays within the oracle margins
    of tests/test_parity_oracle.py, and beats its own BA-off run."""
    sc = next(s for s in SCENARIOS if s.name == "noisy_ba")
    golden = np.load(GOLDEN_DIR / f"{sc.name}.npz")
    assert int(golden["n_frames"]) == sc.n_frames
    world = sc.world()
    frames = list(sc.frames())
    il = np.stack([f[0] for f in frames])
    ir = np.stack([f[1] for f in frames])
    gt = np.array([t for _, _, (_, t) in frames])
    gt_r = np.array([r for _, _, (r, _) in frames])

    def run(**overrides):
        vo = VOSystem(VOConfig(
            fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
            baseline=world.baseline, img_width=world.width,
            img_height=world.height, **overrides), device="cpu")
        poses, metrics = vo.track_chunk(il, ir)
        assert vo.get_state() == TrackingState.TRACKING
        return poses, metrics

    poses, metrics = run(**dict(sc.vo_overrides))
    assert int(metrics.local_ba_ran.sum()) >= 15      # every 4th frame
    est = poses.t.numpy()
    checks = [
        ("ATE", ate_rmse(est, gt), float(golden["ate"]), sc.abs_margin),
        ("RPE(1)", rpe_rmse(est, gt), float(golden["rpe"]), sc.rpe_abs_margin),
        ("rot", rot_rmse_deg(quat.to_matrix(poses.q).numpy(), gt_r),
         float(golden["rot"]), sc.rot_abs_margin),
    ]
    failures = [f"{name}: {ours:.4f} > {oracle * sc.rel_margin + abs_m:.4f}"
                for name, ours, oracle, abs_m in checks
                if ours > oracle * sc.rel_margin + abs_m]
    assert not failures, failures

    off, off_metrics = run()
    assert not bool(off_metrics.local_ba_ran.any())
    ate_ba, ate_off = checks[0][1], ate_rmse(off.t.numpy(), gt)
    assert ate_ba < ate_off, (ate_ba, ate_off)


def test_jax_state_with_a_window_converts_both_ways():
    """A JAX VOState with a nonzero BA window converts to the port's and
    back unchanged."""
    from lvt_tpu.core.state import VOState as JxVOState

    rs = np.random.RandomState(9)
    js = JxVOState.initial(64, 32, ba_window=4)
    ba = js.ba._replace(
        poses_t=jnp.asarray(rs.randn(4, 3).astype(np.float32)),
        obs=jnp.asarray(rs.randn(4, 64, 2).astype(np.float32)),
        w=jnp.asarray((rs.rand(4, 64) > 0.5).astype(np.float32)),
        n=jnp.asarray(3, jnp.int32))
    js = js._replace(ba=ba)
    port = convert.to_port(js, "cpu")
    assert port.ba.obs.shape == (4, 64, 2) and int(port.ba.n) == 3
    back = convert.to_numpy(port)
    want, got = flatten_with_path(js), flatten_with_path(back)
    assert [k for k, _ in want] == [k for k, _ in got]
    for (key, a), (_, b) in zip(want, got):
        a = np.asarray(a)
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)
