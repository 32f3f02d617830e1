"""The tracking branch's four ops (lvt_tpu_torch/core/track.py:
``predict_project``, ``upkeep_pre``, ``staged_promote``,
``triangulate_insert``) on the CPU, where each is its plain version stream
by stream (the CUDA kernels of csrc/track.cu are held against them in
tests/test_torch_cuda.py).

Tolerances:
  * each plain version against lvt_tpu's functions on the same numpy
    inputs: integers, masks, counts, descriptors, slots and the windows
    equal (as tests/test_torch_solver.py and test_torch_matching.py hold
    the bookkeeping, insertion and matching); the motion state and the
    predicted pose within 1e-5 (tests/test_torch_geometry.py's bound);
    projections within 1e-4 px or 1e-5 relative, compared where the camera
    depth exceeds 0.5 m (near the camera plane 1 / z magnifies the last
    bit of XLA's and torch's roundings); triangulated and back-projected
    points within 1e-5 m or 1e-5 relative (test_torch_solver.py's bound
    for triangulate_stereo);
  * the op against its plain version, the single-stream wrapper against
    the op, the op under ``torch.func.vmap`` against each stream alone:
    bit-equal;
  * a numpy model of csrc/track.cu's cluster decomposition of
    ``staged_promote`` and ``triangulate_insert`` (each block a range of
    the queries, of the resolution's targets and of the slots; integers
    exchanged in rank order) against the plain version: bit-equal, NaN for
    NaN; one of ``upkeep_pre_kernel``'s order (tiles of the block's
    threads, the un-marks after the first barrier, the kept count by
    warps, the pose per warp): bit-equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.config import VOConfig as JxConfig
from lvt_tpu.core import map as jx_map
from lvt_tpu.core import step as jx_step
from lvt_tpu.core.features import FrameFeatures as JxFeatures
from lvt_tpu.core.motion import MotionState as JxMotion
from lvt_tpu.core.motion import predict_next_pose as jx_predict
from lvt_tpu.core.state import ObsWindow as JxWindow
from lvt_tpu.core.state import PointStore as JxStore
from lvt_tpu.geometry import se3 as jx_se3
from lvt_tpu.geometry.se3 import Pose as JxPose
from lvt_tpu.ops import matching as jx_matching
from lvt_tpu_torch.config import VOConfig
from lvt_tpu_torch.core import map as map_ops
from lvt_tpu_torch.core import track
from lvt_tpu_torch.core.features import FrameFeatures
from lvt_tpu_torch.core.motion import MotionState
from lvt_tpu_torch.core.state import ObsWindow, PointStore
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.config import MATCHES_WINDOW_INIT
from lvt_tpu_torch.ops import matching, top2, triangulate
from tests.test_torch_cuda import (TRACK_CAM, TRACK_CASES, TRACK_OPS,
                                   _assert_outputs_equal, _case_id,
                                   _track_op, _track_plain, _track_problem,
                                   _track_wrapper)
from tests.test_torch_matching import _desc, _flip_bits
from tests.test_torch_system import share_the_cores  # noqa: F401

CAM_NAMES = track.CAM_KEYS


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jx(x):
    x = _np(x)
    return jnp.asarray(x.view(np.uint32) if x.dtype == np.int32
                       and x.ndim == 2 and x.shape[-1] == 8 else x)


def _stream(args, i):
    return [x[i] if isinstance(x, torch.Tensor) else x for x in args]


def _wrapper_outputs(name, res) -> tuple:
    """A wrapper's result as the op's outputs (one stream)."""
    if name == "predict_project":
        motion, pred, uv, vis = res
        return (torch.cat(list(motion)), torch.cat(list(pred)), uv, vis)
    if name == "upkeep_pre":
        return (res.bookkept.counter, res.bookkept.age, res.clean.valid,
                res.feature_matched, res.staged_targets, res.map_size,
                torch.cat(list(res.pose)), res.staged_uv, res.staged_visible)
    if name == "staged_promote":
        return (res.staged.counter, res.staged.valid, res.feature_matched,
                *res.map, res.taken)
    if name == "ba_observe":
        window, do_ba = res
        return (*window, do_ba)
    return (*res.map, res.map_taken, *res.staged, res.n_inserted,
            res.map_size, res.window, res.points, res.valid)


@pytest.mark.parametrize("c", TRACK_CASES, ids=[_case_id(c) for c in
                                                TRACK_CASES])
def test_track_op_on_the_cpu_is_its_plain_version(c):
    """The op's CPU kernel is its plain version stream by stream, and the
    single-stream wrapper (the step's call) gives stream 0's bits."""
    name, s, case, kw = c
    args = _track_problem(np.random.RandomState(len(name) + s), name, s,
                          "cpu", case, **kw)
    got = _track_op(name)(*args)
    _assert_outputs_equal(got, _track_plain(name, args), name)
    wrapped = _wrapper_outputs(name, _track_wrapper(name, args))
    _assert_outputs_equal(wrapped, [x[0] for x in got], f"{name} wrapper")


@pytest.mark.parametrize("name", TRACK_OPS)
def test_track_op_vmap_rule_is_each_stream_alone(name):
    """Under ``torch.func.vmap`` over 3 streams (the multi-stream step) the
    batching rule's one call gives each stream the bits of its own call."""
    args = _track_problem(np.random.RandomState(11), name, 3, "cpu")
    tensors = [x for x in args if isinstance(x, torch.Tensor)]
    rest = args[len(tensors):]
    op = _track_op(name)
    got = torch.func.vmap(lambda *a: op(*(x[None] for x in a), *rest))(
        *tensors)
    for i in range(3):
        alone = op(*(x[i:i + 1] for x in tensors), *rest)
        _assert_outputs_equal([x[i, 0] for x in got], [x[0] for x in alone],
                              f"{name} stream {i}")


@pytest.mark.parametrize("name", TRACK_OPS)
def test_track_op_opcheck(name):
    """``torch.library.opcheck``: schema, fake kernel, autograd
    registration and AOT dispatch on the CPU kernel (ba_observe's window
    without NaN: opcheck compares its runs with NaN unequal to itself)."""
    args = _track_problem(np.random.RandomState(5), name, 2, "cpu",
                          "finite" if name == "ba_observe" else "random",
                          m=64, k=96, n=48)
    torch.library.opcheck(_track_op(name), tuple(args))


# ---- the plain versions against lvt_tpu

def _projection_matches_lvt_tpu(uv_port, vis_port, pts, pose, cam, valid):
    """The port's projection and visibility of world points ``pts`` at
    ``pose`` against lvt_tpu's se3 functions; returns where the camera
    depth exceeds 0.5 m (where uv is compared)."""
    jcam = jx_se3.transform_points(jx_se3.world_to_camera(pose), _jx(pts))
    juv = jx_se3.project_points(jcam, cam["fx"], cam["fy"], cam["cx"],
                                cam["cy"])
    jvis = _jx(valid) & jx_se3.visibility_mask(
        jcam, juv, *(cam[k] for k in CAM_NAMES[4:]))
    far = np.abs(np.asarray(jcam)[:, 2]) > 0.5
    np.testing.assert_allclose(_np(uv_port)[far], np.asarray(juv)[far],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(_np(vis_port), np.asarray(jvis))
    return far


@pytest.mark.parametrize("case", ["random", "init"])
def test_predict_project_plain_matches_lvt_tpu(case):
    """Motion update, prediction (the identity on the init frame) and the
    map's projection at it, on 4 streams (stream 2 on slerp's
    near-parallel branch, stream 3 with a negated angular velocity)."""
    args = _track_problem(np.random.RandomState(2), "predict_project", 4,
                          "cpu", case, m=600)
    cam = dict(TRACK_CAM)
    for i in range(4):
        lq, lp, lv, av, t, q, is_init, pos, valid, _ = _stream(args, i)
        motion, pred, uv, vis = track.predict_project_plain(
            MotionState(lq, lp, lv, av), Pose(t, q), is_init, pos, valid,
            cam)
        jm, jp = jx_predict(JxMotion(*map(_jx, (lq, lp, lv, av))),
                            JxPose(_jx(t), _jx(q)))
        if bool(is_init):
            jm = JxMotion(*map(_jx, (lq, lp, lv, av)))
            jp = JxPose(jnp.zeros(3), jnp.array([1.0, 0.0, 0.0, 0.0]))
        for got, want in zip((*motion, *pred), (*jm, *jp)):
            np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
        far = _projection_matches_lvt_tpu(uv, vis, pos, jp, cam, valid)
        assert far.sum() > 400 and _np(vis).sum() > 50


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "none"])
def test_upkeep_pre_plain_matches_lvt_tpu(staged):
    """The map's bookkeeping and cull with the un-marks, the frame's pose
    and the staged points' projection (none: an empty staged set)."""
    args = _track_problem(np.random.RandomState(3), "upkeep_pre", 2, "cpu",
                          m=512, k=640, n=400 if staged else 0)
    cam = dict(TRACK_CAM)
    for i in range(2):
        (counter, age, valid, match_idx, fm, fvalid, t, q, is_init, spos,
         svalid, threshold, _) = _stream(args, i)
        pos = torch.zeros(counter.shape[0], 3)
        desc = torch.zeros(counter.shape[0], 8, dtype=torch.int32)
        store = PointStore(pos, desc, counter, age, valid)
        u = track.upkeep_pre_plain(store, match_idx, fm, fvalid, Pose(t, q),
                                   is_init, spos, svalid, threshold, cam)
        jstore = JxStore(*map(_jx, store))
        jb = jx_map.apply_match_bookkeeping(jstore, _jx(match_idx))
        jc, jfm = jx_map.clean_untracked(jb, _jx(match_idx), _jx(fm),
                                         threshold)
        for got, want in ((u.bookkept.counter, jb.counter),
                          (u.bookkept.age, jb.age), (u.clean.valid, jc.valid),
                          (u.feature_matched, jfm),
                          (u.staged_targets, _jx(fvalid) & ~jfm),
                          (u.map_size, jc.valid.sum())):
            np.testing.assert_array_equal(_np(got), np.asarray(want))
        pose = (JxPose(jnp.zeros(3), jnp.array([1.0, 0.0, 0.0, 0.0]))
                if bool(is_init) else JxPose(_jx(t), _jx(q)))
        np.testing.assert_array_equal(_np(u.pose.t), np.asarray(pose.t))
        np.testing.assert_array_equal(_np(u.pose.q), np.asarray(pose.q))
        if staged:
            _projection_matches_lvt_tpu(u.staged_uv, u.staged_visible,
                                        spos, pose, cam, svalid)
        assert int(u.map_size) < int(valid.sum())


def _jx_config(**kw) -> JxConfig:
    return JxConfig(fx=TRACK_CAM["fx"], fy=TRACK_CAM["fy"],
                    cx=TRACK_CAM["cx"], cy=TRACK_CAM["cy"],
                    baseline=0.537165718864, img_width=1241, img_height=376,
                    near_plane_distance=TRACK_CAM["near"],
                    far_plane_distance=TRACK_CAM["far"],
                    use_pallas_matching=False, use_mxu_hamming=False, **kw)


def _port_config(**kw) -> VOConfig:
    return VOConfig(fx=TRACK_CAM["fx"], fy=TRACK_CAM["fy"],
                    cx=TRACK_CAM["cx"], cy=TRACK_CAM["cy"],
                    baseline=0.537165718864, img_width=1241, img_height=376,
                    near_plane_distance=TRACK_CAM["near"],
                    far_plane_distance=TRACK_CAM["far"], **kw)


def _scene(rs, k, n_pts):
    """Left and right features of a stereo frame at the identity: the
    projections of ``n_pts`` points 3-120 m deep with 0.3 px noise and
    their descriptors a few bits apart, the right features permuted; the
    rest clutter. Returns (left, right) numpy tuples in FrameFeatures'
    order, the points' left slots and their world positions."""
    z = rs.uniform(3.0, 120.0, n_pts)
    u = rs.uniform(20, 1220, n_pts)
    v = rs.uniform(20, 356, n_pts)
    fx, b = TRACK_CAM["fx"], 0.537165718864
    kp_l = np.stack([rs.uniform(0, 1241, k), rs.uniform(0, 376, k)], -1)
    kp_l[:n_pts] = np.stack([u, v], -1)
    desc_l = _desc(rs, k)
    perm = rs.permutation(k)
    kp_r = np.stack([rs.uniform(0, 1241, k), rs.uniform(0, 376, k)], -1)
    desc_r = _desc(rs, k)
    kp_r[perm[:n_pts]] = np.stack([u - fx * b / z, v], -1) + rs.randn(
        n_pts, 2) * 0.3
    desc_r[perm[:n_pts]] = _flip_bits(rs, desc_l[:n_pts], 6)
    zero = np.zeros(k, np.float32)
    depth = np.zeros(k, np.float32)
    depth[:n_pts] = z
    left = (kp_l.astype(np.float32), desc_l, zero, depth, rs.rand(k) > 0.05)
    right = (kp_r.astype(np.float32), desc_r, zero, zero, rs.rand(k) > 0.05)
    return left, right


def _features(arrays, jax=False):
    if jax:
        return JxFeatures(*map(jnp.asarray, arrays))
    return FrameFeatures(*(torch.from_numpy(
        a.view(np.int32) if a.dtype == np.uint32 else a) for a in arrays))


def _stores_np(rs, c, frac):
    return (rs.randn(c, 3).astype(np.float32),
            rs.randint(0, 2**32, (c, 8), dtype=np.uint64).astype(np.uint32),
            rs.randint(0, 3, c).astype(np.int32),
            rs.randint(0, 9, c).astype(np.int32), rs.rand(c) < frac)


def _port_store(arrays):
    return PointStore(*(torch.from_numpy(
        a.view(np.int32) if a.dtype == np.uint32 else a) for a in arrays))


def _assert_store(got, want, pos_tol=None):
    for name, g, w in zip(got._fields, got, want):
        g, w = _np(g), np.asarray(w)
        if name == "desc":
            g = g.view(np.uint32)
        if name == "pos" and pos_tol:
            np.testing.assert_allclose(g, w, rtol=pos_tol, atol=pos_tol)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("map_size", [100, 400], ids=["promote", "mature"])
def test_staged_halves_match_lvt_tpu(map_size):
    """The staged re-match as the step runs it (upkeep_pre's projection,
    kernel T's plain version, staged_promote_plain) against lvt_tpu's
    ``_staged_update`` and the insertion of its promotions: staged
    counters and validity, claims, the map after the promotions and its
    taken slots."""
    rs = np.random.RandomState(map_size)
    k, n, m = 640, 300, 256
    left, _ = _scene(rs, k, 400)
    depth = left[3]
    src = rs.choice(400, 200, replace=False)
    staged = list(_stores_np(rs, n, 0.8))
    staged[0][:200] = np.stack([
        (left[0][src, 0] - TRACK_CAM["cx"]) / TRACK_CAM["fx"] * depth[src],
        (left[0][src, 1] - TRACK_CAM["cy"]) / TRACK_CAM["fy"] * depth[src],
        depth[src]], -1) + rs.randn(200, 3).astype(np.float32) * 0.01
    staged[1][:200] = _flip_bits(rs, left[1][src], 5)
    staged = tuple(staged)
    mp = _stores_np(rs, m, 0.6)
    fm = rs.rand(k) > 0.8
    kw = dict(staged_threshold=2, tracking_radius=25,
              tracking_ratio_test_threshold=0.8,
              descriptor_matching_threshold=30.0)
    config, jconfig = _port_config(**kw), _jx_config(**kw)
    t = np.array([0.01, -0.02, 0.03], np.float32)
    q = np.array([1.0, 0.001, -0.002, 0.0005], np.float32)
    q /= np.linalg.norm(q)
    feats = _features(left)
    store, st = _port_store(mp), _port_store(staged)
    cam = dict(TRACK_CAM)
    uv, vis = matching.project_visible(st.pos, st.valid,
                                       Pose(torch.from_numpy(t),
                                            torch.from_numpy(q)), **cam)
    (top2, _) = matching.dual_radius_top2(
        st.desc, feats.desc, uv, vis, feats.kp,
        feats.valid & ~torch.from_numpy(fm), 25, 25)
    size = torch.tensor(map_size)
    got = track.staged_promote_plain(
        top2, st, torch.from_numpy(fm), size, store,
        ratio_threshold=config.tracking_ratio_test_threshold,
        abs_threshold=config.descriptor_matching_threshold,
        staged_threshold=2, map_soft_cap=config.map_soft_cap)
    jst, promo, jfm = jx_step._staged_update(
        JxStore(*map(jnp.asarray, staged)), JxPose(jnp.asarray(t),
                                                   jnp.asarray(q)),
        _features(left, jax=True), jnp.asarray(fm), jnp.asarray(map_size),
        jconfig)
    p_pos, p_desc, p_ctr, p_age, p_mask = promo
    jins = jx_map.insert_points(JxStore(*map(jnp.asarray, mp)), p_pos, p_desc,
                                p_mask, new_counter=p_ctr, new_age=p_age)
    _assert_store(got.staged, jst)
    np.testing.assert_array_equal(_np(got.feature_matched), np.asarray(jfm))
    _assert_store(got.map, jins.store)
    np.testing.assert_array_equal(_np(got.taken), np.asarray(jins.taken))
    assert int(got.staged.counter.sum()) > int(st.counter.sum()) + 50
    assert int(got.taken.sum()) > (20 if map_size < 250 else -1)


@pytest.mark.parametrize("case", ["no_free_slot", "every_slot_free",
                                  "more_than_capacity", "no_point"])
def test_insert_points_edges_match_lvt_tpu(case):
    """insert_points, which staged_promote and triangulate_insert run, at
    its edges: no free slot, every slot free, more new points (K = 300)
    than the store holds (50), an all-false mask."""
    rs = np.random.RandomState(len(case))
    cap, k = (50, 300) if case == "more_than_capacity" else (128, 256)
    frac = {"no_free_slot": 1.0, "every_slot_free": 0.0}.get(case, 0.5)
    arrays = _stores_np(rs, cap, frac)
    new_pos = rs.randn(k, 3).astype(np.float32)
    new_desc = rs.randint(0, 2**32, (k, 8), dtype=np.uint64).astype(np.uint32)
    mask = rs.rand(k) < (0.0 if case == "no_point" else
                         1.0 if case == "more_than_capacity" else 0.3)
    ctr = rs.randint(0, 5, k).astype(np.int32)
    got = map_ops.insert_points(_port_store(arrays), torch.from_numpy(new_pos),
                                torch.from_numpy(new_desc.view(np.int32)),
                                torch.from_numpy(mask),
                                new_counter=torch.from_numpy(ctr))
    want = jx_map.insert_points(JxStore(*map(jnp.asarray, arrays)),
                                jnp.asarray(new_pos), jnp.asarray(new_desc),
                                jnp.asarray(mask),
                                new_counter=jnp.asarray(ctr))
    _assert_store(got.store, want.store)
    for name in ("n_inserted", "n_dropped", "taken"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
    free = int((~arrays[4]).sum())
    assert int(got.n_inserted) == min(free, int(mask.sum()))


@pytest.mark.parametrize("sensor,policy,is_init", [
    ("stereo", 1, False), ("stereo", 1, True), ("stereo", 2, False),
    ("stereo", 3, False), ("rgbd", 2, False)])
def test_triangulate_insert_plain_matches_lvt_tpu(sensor, policy, is_init):
    """The row match's acceptance and resolution, triangulation (or RGB-D
    back-projection), the policy and both insertions against lvt_tpu's
    ``_triangulate_new_points``, ``_policy_need_triangulation`` and
    ``insert_points`` with the step's split between map and staged set."""
    rs = np.random.RandomState(policy + 10 * is_init)
    k, m, n = 512, 256, 200
    left, right = _scene(rs, k, 350)
    rgbd = sensor == "rgbd"
    mp, st = _stores_np(rs, m, 0.3), _stores_np(rs, n, 0.5)
    fm = rs.rand(k) > 0.8
    last = np.array([1e9, 400.0, 300.0], np.float32)
    count = np.int64(250)
    kw = dict(staged_threshold=2, triangulation_policy=policy,
              row_matching_vertical_search_radius=2,
              triangulation_ratio_test_threshold=0.6,
              descriptor_matching_threshold=30.0)
    config, jconfig = _port_config(**kw), _jx_config(**kw)
    t = np.array([0.3, -0.1, 2.0], np.float32)
    q = np.array([1.0, 0.01, -0.02, 0.005], np.float32)
    q /= np.linalg.norm(q)
    lf = _features(left)
    rf = None if rgbd else _features(right)
    row_top2 = None
    if not rgbd:
        row_top2 = top2._unpack(*matching.row_top2_packed(
            lf, rf, torch.from_numpy(fm), vertical_search_radius=2,
            img_rows=376))[0]
    got = track.triangulate_insert_plain(
        row_top2, lf.kp, None if rgbd else rf.kp, lf.depth if rgbd else None,
        lf.valid, lf.desc, Pose(torch.from_numpy(t), torch.from_numpy(q)),
        _port_store(mp), _port_store(st), torch.from_numpy(last),
        torch.tensor(count), torch.tensor(is_init), dict(TRACK_CAM),
        track.TriangulationParams.of(config))
    pts, desc, valid = jx_step._triangulate_new_points(
        _features(left, jax=True),
        None if rgbd else _features(right, jax=True),
        jnp.asarray(fm), JxPose(jnp.asarray(t), jnp.asarray(q)), jconfig,
        rgbd)
    window = jnp.concatenate([jnp.asarray(last[1:]),
                              jnp.asarray(count, jnp.float32)[None]])
    jmap = JxStore(*map(jnp.asarray, mp))
    size = jmap.valid.sum()
    need = jx_step._policy_need_triangulation(jconfig, window, size) | is_init
    valid = valid & need
    to_map = size < jconfig.map_soft_cap
    ins_map = jx_map.insert_points(jmap, pts, desc, valid & to_map)
    ins_st = jx_map.insert_points(JxStore(*map(jnp.asarray, st)), pts, desc,
                                  valid & ~to_map)
    final = ins_map.store.valid.sum()
    want_window = np.asarray(window) if not is_init else np.array(
        [float(final), 1e9, 1e9], np.float32)
    np.testing.assert_array_equal(_np(got.valid), np.asarray(valid))
    v = np.asarray(valid)
    np.testing.assert_allclose(_np(got.points)[v], np.asarray(pts)[v],
                               rtol=1e-5, atol=1e-5)
    _assert_store(got.map, ins_map.store, pos_tol=1e-5)
    _assert_store(got.staged, ins_st.store, pos_tol=1e-5)
    np.testing.assert_array_equal(_np(got.map_taken),
                                  np.asarray(ins_map.taken))
    assert int(got.n_inserted) == int(ins_map.n_inserted + ins_st.n_inserted)
    assert int(got.map_size) == int(final)
    np.testing.assert_array_equal(_np(got.window), want_window)
    assert v.sum() > (50 if bool(need) else -1)


@pytest.mark.parametrize("case", ["frame", "empty", "full", "culled",
                                  "none"])
def test_ba_observe_plain_matches_lvt_tpu(case):
    """ba_observe's plain version, fed kernel T's dual row launch (the
    triangulation's and the BA's query sets), against lvt_tpu's BA row
    match and observations (lvt_tpu/core/step.py:486-512: ``row_match``
    over the map-matched features, the gathers of r_idx, obs_r and w_r)
    and its ``_local_ba_update`` (its slide, :232-267), bit for bit: the
    seven leaves of the window and the schedule (BA due on the full
    window only). ``empty``: n = 0; ``full``: n = F, BA due;
    ``culled``: many slots culled and recycled; ``none``: no map match."""
    rs = np.random.RandomState(["frame", "empty", "full", "culled",
                                "none"].index(case))
    k, m, f = 384, 256, 4
    left, right = _scene(rs, k, 300)
    kw = dict(local_ba_window=f, local_ba_every=4,
              row_matching_vertical_search_radius=2,
              triangulation_ratio_test_threshold=0.6,
              descriptor_matching_threshold=30.0)
    jconfig = _jx_config(**kw)
    mm_fm = rs.rand(k) < (0.0 if case == "none" else 0.6)
    mm_fm &= left[4]
    tri_excl = mm_fm | (rs.rand(k) < 0.1)   # after the promotions' claims
    match_idx = np.full(m, -1, np.int64)
    match_idx[rs.rand(m) < 0.2] = -2
    claimed = np.flatnonzero(mm_fm)
    slots = rs.choice(m, min(m, claimed.size), replace=False)
    match_idx[slots] = rs.permutation(claimed)[:slots.size]
    obs = left[0][np.clip(match_idx, 0, k - 1)]
    weights = (match_idx >= 0).astype(np.float32)
    t = np.array([0.3, -0.1, 2.0], np.float32)
    q = np.array([1.0, 0.01, -0.02, 0.005], np.float32)
    q /= np.linalg.norm(q)
    n = {"empty": 0, "full": f}.get(case, 2)
    win = (rs.randn(f, 3).astype(np.float32),
           rs.randn(f, 4).astype(np.float32),
           rs.uniform(0, 1241, (f, m, 2)).astype(np.float32),
           (rs.rand(f, m) < 0.6).astype(np.float32),
           rs.uniform(0, 1241, (f, m, 2)).astype(np.float32),
           (rs.rand(f, m) < 0.4).astype(np.float32), np.int32(n))
    cull = 0.3 if case == "culled" else 0.05
    mvalid = rs.rand(m) > 0.2
    bvalid = mvalid | (rs.rand(m) < cull)
    cvalid = bvalid & (rs.rand(m) > cull)
    taken, ptaken = rs.rand(m) < cull, rs.rand(m) < cull
    frame = np.int32(8 if case == "full" else 9)   # BA due, or not

    lf, rf = _features(left), _features(right)
    packed = matching.row_top2_packed(
        lf, rf, torch.from_numpy(tri_excl), torch.from_numpy(mm_fm),
        vertical_search_radius=2, img_rows=376)
    got, do_ba = track.ba_observe_plain(
        top2._unpack(*packed)[1], torch.from_numpy(match_idx),
        torch.from_numpy(obs), torch.from_numpy(weights), rf.kp,
        Pose(torch.from_numpy(t), torch.from_numpy(q)),
        ObsWindow(*map(torch.as_tensor, win)), *map(torch.from_numpy, (
            mvalid, bvalid, cvalid, taken, ptaken)), torch.tensor(frame),
        ratio_threshold=0.6, abs_threshold=30.0, local_ba_every=4)

    jl, jr = _features(left, jax=True), _features(right, jax=True)
    rm_ba = jx_matching.row_match(
        jl, jr, jnp.logical_not(jnp.asarray(mm_fm)),
        vertical_search_radius=2, ratio_threshold=0.6, abs_threshold=30.0,
        img_rows=376, use_kernel=False, use_mxu=False)
    jmi = jnp.asarray(match_idx)
    r_idx = rm_ba.right_idx[jnp.clip(jmi, 0, k - 1)]
    obs_r = jr.kp[jnp.clip(r_idx, 0, k - 1)]
    w_r = ((jmi >= 0) & (r_idx >= 0)).astype(jnp.float32)
    removed = jnp.asarray(bvalid & ~cvalid)
    recycled = jnp.asarray(taken | ptaken)
    store = JxStore(*map(jnp.asarray, _stores_np(rs, m, 0.5)))
    store = store._replace(valid=jnp.asarray(mvalid))
    want, pose, pos = jx_step._local_ba_update(
        JxWindow(*map(jnp.asarray, win)), store,
        JxPose(jnp.asarray(t), jnp.asarray(q)), jnp.asarray(obs),
        jnp.asarray(weights), obs_r, w_r, removed | recycled,
        jnp.asarray(frame), jconfig)
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=name)
    # lvt_tpu's schedule (:259): BA ran exactly where its positions moved
    due = (want.n >= f) & (jnp.asarray(frame) % jconfig.local_ba_every == 0)
    assert bool(do_ba) == bool(due) == (case == "full")
    assert np.array_equal(np.asarray(pos), np.asarray(store.pos)) != due
    assert (int(np.asarray(w_r).sum()) > 20) == (case != "none")


# ---- the step's calls

def _count_op_calls(monkeypatch) -> dict:
    """Each op's calls on unbatched tensors (a vmapped step's one call per
    frame comes from the batching rule), counted."""
    counts = dict.fromkeys(TRACK_OPS, 0)
    for name in TRACK_OPS:
        real = getattr(track, f"{name}_op")

        def counted(*args, _real=real, _name=name):
            if not torch._C._functorch.is_batchedtensor(args[0]):
                counts[_name] += 1
            return _real(*args)

        monkeypatch.setattr(track, f"{name}_op", counted)
    return counts


def _small_frames(n):
    from tests.test_torch_system import _world

    world = _world()
    frames = [(l.astype(np.uint8), r.astype(np.uint8))
              for l, r, _ in world.stereo_sequence(n, speed=0.5)]
    return (world, np.stack([f[0] for f in frames]),
            np.stack([f[1] for f in frames]))


@pytest.mark.parametrize("staged_threshold", [2, 0])
def test_step_calls_each_op_once_per_frame(monkeypatch, staged_threshold):
    """Without a group the step calls each op once per frame, one stream
    or (under vmap) 3 streams at once; ``staged_promote`` not without a
    staged set; the wrappers count no launch on the CPU."""
    from lvt_tpu_torch.core.system import VOSystem
    from lvt_tpu_torch.parallel.multistream import MultiStreamVO
    from tests.test_torch_system import _config

    world, il, ir = _small_frames(3)
    config = dataclasses.replace(_config(world),
                                 staged_threshold=staged_threshold)
    launches = {name: getattr(track, name).launches for name in TRACK_OPS}
    counts = _count_op_calls(monkeypatch)
    VOSystem(config, device="cpu").track_chunk(il, ir)
    want = {name: 3 for name in TRACK_OPS}
    if staged_threshold == 0:
        want["staged_promote"] = 0
    if config.local_ba_window == 0:
        want["ba_observe"] = 0
    assert counts == want
    counts.update(dict.fromkeys(TRACK_OPS, 0))
    MultiStreamVO(config, 3, device="cpu").track_chunk(
        np.repeat(il[:2, None], 3, 1), np.repeat(ir[:2, None], 3, 1))
    assert counts == {k: v * 2 // 3 for k, v in want.items()}
    assert {name: getattr(track, name).launches
            for name in TRACK_OPS} == launches


def test_the_sharded_step_calls_no_op(monkeypatch, tmp_path):
    """With a group (a one-rank gloo group, ``ShardedStreamVO``) the step
    calls no op whose collectives sit in the middle of its work
    (``staged_promote``, ``triangulate_insert``: their plain versions and
    collectives run); ``predict_project``, ``upkeep_pre`` and, with local
    BA, ``ba_observe``, which reduce over no rank mid-way, are called once
    per frame on the rank's block."""
    import torch.distributed as dist

    from lvt_tpu_torch.parallel import mesh as mesh_mod
    from lvt_tpu_torch.parallel.sharded_stream import ShardedStreamVO
    from tests.test_torch_system import _config

    world, il, ir = _small_frames(2)
    config = _config(world)
    counts = _count_op_calls(monkeypatch)
    mesh_mod.init("gloo", 1, 0, f"file://{tmp_path / 'rdv'}")
    try:
        ShardedStreamVO(config, device="cpu").track_chunk(il, ir)
    finally:
        dist.destroy_process_group()
    want = dict.fromkeys(TRACK_OPS, 0)
    want.update(predict_project=2, upkeep_pre=2,
                ba_observe=2 * (config.local_ba_window > 0))
    assert counts == want


ROUTED_CASES = [c for c in TRACK_CASES if c[0] in track.GROUP_OPS
                and c[1] <= 8 and c[2] != "init"]


@pytest.mark.parametrize("c", ROUTED_CASES,
                         ids=[_case_id(c) for c in ROUTED_CASES])
def test_routed_wrappers_under_a_group_are_the_plain_group_versions(
        c, tmp_path):
    """On a one-rank gloo group the wrappers that launch their kernels
    under a group (``track.GROUP_OPS``) give their plain group versions'
    outputs bit for bit, stream 0 of each case; ``upkeep_pre`` with its
    two collectives."""
    import torch.distributed as dist

    from lvt_tpu_torch.ops.collectives import all_reduce
    from lvt_tpu_torch.parallel import mesh as mesh_mod
    from tests.test_torch_cuda import _track_plain_group

    name, s, case, kw = c
    args = _track_problem(np.random.RandomState(11), name, s, "cpu", case,
                          **kw)
    mesh_mod.init("gloo", 1, 0, f"file://{tmp_path / 'rdv'}")
    try:
        group = dist.group.WORLD
        before = all_reduce.calls
        got = _wrapper_outputs(name, _track_wrapper(name, args, group))
        n_coll = all_reduce.calls - before
        want = _wrapper_outputs(name, _track_plain_group(name, args, group))
    finally:
        dist.destroy_process_group()
    _assert_outputs_equal(got, want, name)
    assert n_coll == (2 if name == "upkeep_pre" else 0)


# ---- the cluster kernels' decomposition (csrc/track.cu), modelled in numpy

IMAX = np.iinfo(np.int32).max
# the cases of the model (_track_problem's): the stores' occupancy, no
# candidate, ragged ranges (the last blocks' ranges empty at C = 8 and 16)
MODEL_CASES = [("random", {}), ("full", {}), ("empty", {}), ("none", {}),
               ("none_full", {}), ("random", {"m": 50, "k": 300, "n": 40}),
               ("random", {"m": 9, "k": 10, "n": 3})]
TRI_MODEL_CASES = MODEL_CASES + [
    ("random", {"rgbd": True}), ("random", {"policy": 3}),
    ("random", {"staged_threshold": 0})]
SMALL = {"m": 256, "k": 384, "n": 200}   # the sizes where a case has none


def _blocks(n, c):
    """Each block's range [lo, hi) of an axis of n over a cluster of c
    (track.cu's range_of), and the range's length."""
    per = -(-n // c)
    return [(min(n, r * per), min(n, (r + 1) * per)) for r in range(c)], per


def _accept(d1, d2, best, n_cand, ratio, abs_th):
    ok = (((n_cand >= 2) & (d1 < np.float32(ratio) * d2))
          | ((n_cand == 1) & (d1 <= np.float32(abs_th))))
    return np.where(ok, best, -1)


def _resolve(idx, d1, k, c):
    """The one-to-one resolution over a cluster of c: each block's accepted
    queries send their key to the owner of their target (of the K + 1 in
    blocks), which keeps the minimum; a query won where its owner's key is
    its own. Returns the resolved index (-1: lost or rejected)."""
    n = idx.shape[0]
    key = (np.where(idx >= 0, d1, 0).astype(np.int32) * np.int32(n + 1)
           + np.arange(n, dtype=np.int32))
    _, per = _blocks(k + 1, c)
    keys = np.full((c, per), IMAX, np.int32)   # row o: owner o's keys
    for lo, hi in _blocks(n, c)[0]:
        for q in range(lo, hi):
            if idx[q] >= 0:
                o, at = divmod(int(idx[q]), per)
                keys[o, at] = min(keys[o, at], key[q])
    won = np.array([idx[q] >= 0 and keys[divmod(int(idx[q]), per)] == key[q]
                    for q in range(n)], bool)
    return np.where(won, idx, -1)


def _insert(store, new, cand, c):
    """insert_points over a cluster of c: block b's free slots in index
    order after the ranks' free counts before b, a slot of global free rank
    g taking the candidate of global rank g, found through the prefix of
    the blocks' candidate counts (``cand``: each block's candidates, new
    point indices in index order). Returns (store', taken, inserted)."""
    pos, desc, ctr, age, valid = (np.array(x) for x in store)
    n_pos, n_desc, n_ctr, n_age = new
    blocks, _ = _blocks(valid.shape[0], c)
    free_before = np.cumsum([0] + [int((~valid[lo:hi]).sum())
                                   for lo, hi in blocks])
    cand_pre = np.cumsum([0] + [len(x) for x in cand])
    taken = np.zeros_like(valid)
    for b, (lo, hi) in enumerate(blocks):
        local = np.cumsum(~valid[lo:hi]) - 1
        for i in range(hi - lo):
            g = free_before[b] + local[i]
            if valid[lo + i] or g >= cand_pre[-1]:
                continue
            o = int(np.searchsorted(cand_pre, g, side="right")) - 1
            src = cand[o][g - cand_pre[o]]
            p = lo + i
            pos[p], desc[p], ctr[p], age[p] = (n_pos[src], n_desc[src],
                                               n_ctr[src], n_age[src])
            taken[p] = True
    return ((pos, desc, ctr, age, valid | taken), taken,
            min(free_before[-1], cand_pre[-1]))


def _staged_model(a, c):
    """staged_promote of one stream (the op's arguments as numpy) over a
    cluster of c blocks."""
    (d1, d2, best, n_cand, s_pos, s_desc, s_ctr, s_age, s_valid, fm,
     map_size, *mp), (ratio, abs_th, thr, cap) = a[:16], a[16:]
    k = fm.shape[0]
    won = _resolve(_accept(d1, d2, best, n_cand, ratio, abs_th), d1, k, c)
    matched = won >= 0
    # the claims, each owner's range of the features with its winners
    t_blocks, _ = _blocks(k + 1, c)
    claims = np.concatenate([fm[lo:min(hi, k)] | np.isin(
        np.arange(lo, min(hi, k)), won[matched]) for lo, hi in t_blocks])
    ctr = np.where(matched, s_ctr + 1, s_ctr).astype(np.int32)
    promote = s_valid & matched & ((s_ctr + 1 == thr) | (map_size < cap))
    cand = [np.nonzero(promote[lo:hi])[0] + lo
            for lo, hi in _blocks(d1.shape[0], c)[0]]
    store, taken, _ = _insert(mp, (s_pos, s_desc, ctr, s_age), cand, c)
    return (ctr, s_valid & matched & ~promote, claims, *store, taken)


def _tri_model(a, c):
    """triangulate_insert of one stream (the op's arguments, tensors)
    over a cluster of c blocks: the map's size from the blocks' counts, the
    row resolution by owners, each block's features triangulated (the
    plain version's elementwise ops on its slice), the candidates inserted
    by global rank."""
    rgbd, fl, ints = a[24:]
    cam = dict(zip(track.CAM_KEYS, fl[:len(track.CAM_KEYS)]))
    prm = track._params(fl, ints)
    (d1, d2, best, n_cand, kp, right_kp, depth, feat_valid, desc, t, q,
     *stores, last, count, is_init) = a[:24]
    mp, st = [_np(x) for x in stores[:5]], [_np(x) for x in stores[5:]]
    k = kp.shape[0]
    f_blocks, _ = _blocks(k, c)
    map_size = sum(int(mp[4][lo:hi].sum())
                   for lo, hi in _blocks(mp[4].shape[0], c)[0])
    window = np.array([_np(last)[1], _np(last)[2], np.float32(_np(count))],
                      np.float32)
    if prm.policy == 2:
        need = True
    elif prm.policy == 3:
        need = map_size < 1000
    else:
        r = np.float32(0.99)
        need = window[1] <= r * window[0] and window[2] <= r * window[1]
    need = bool(need) or bool(is_init)
    to_map = map_size < prm.map_soft_cap or prm.staged_threshold == 0
    pose = Pose(t, q)
    if not rgbd:
        won = torch.from_numpy(_resolve(
            _accept(*(_np(x) for x in (d1, d2, best, n_cand)),
                    prm.ratio_threshold, prm.abs_threshold), _np(d1), k, c))
    pts, ok = [], []
    for lo, hi in f_blocks:
        if hi == lo:
            continue
        if rgbd:
            res = triangulate.backproject_rgbd(
                kp[lo:hi], depth[lo:hi], feat_valid[lo:hi], pose,
                fx=cam["fx"], fy=cam["fy"], cx=cam["cx"], cy=cam["cy"])
        else:
            res = triangulate.triangulate_stereo(
                kp[lo:hi], right_kp[torch.clamp(won[lo:hi], 0, k - 1)],
                won[lo:hi] >= 0, pose, baseline=prm.baseline,
                reprojection_th2=prm.reprojection_th2, **cam)
        pts.append(_np(res.points_world))
        ok.append(_np(res.valid))
    pts = np.concatenate(pts) if pts else np.zeros((0, 3), np.float32)
    cand = (np.concatenate(ok) if ok else np.zeros(0, bool)) & need
    lists = [np.nonzero(cand[lo:hi])[0] + lo for lo, hi in f_blocks]
    zero = np.zeros(k, np.int32)
    new = (pts, _np(desc), zero, zero)
    none = [np.zeros(0, np.int64)] * c
    mp, taken, in_map = _insert(mp, new, lists if to_map else none, c)
    st, _, in_st = _insert(st, new, none if to_map else lists, c)
    size = map_size + in_map
    if bool(is_init):
        window = np.array([size, MATCHES_WINDOW_INIT, MATCHES_WINDOW_INIT],
                          np.float32)
    return (*mp, taken, *st, in_map + in_st, size, window, pts, cand)


@pytest.mark.parametrize("c", [1, 2, 8, 16])
@pytest.mark.parametrize("case,kw", MODEL_CASES,
                         ids=[_case_id(("", 0, c, kw)) for c, kw in
                              MODEL_CASES])
def test_staged_promote_cluster_model_is_the_plain_version(case, kw, c):
    """csrc/track.cu's staged_promote_kernel as a numpy model over a
    cluster of c blocks (c = 16 past the kernel's 8: the decomposition
    holds at any c) against staged_promote_plain, stream by stream, every
    output equal; the ragged shapes leave the last blocks' ranges empty."""
    args = _track_problem(np.random.RandomState(c), "staged_promote", 2,
                          "cpu", case, **(kw or SMALL))
    want = _track_plain("staged_promote", args)
    for i in range(2):
        a = [_np(x[i]) if isinstance(x, torch.Tensor) else x for x in args]
        for g, w in zip(_staged_model(a, c), (x[i] for x in want)):
            np.testing.assert_array_equal(np.asarray(g), _np(w))


@pytest.mark.parametrize("c", [1, 2, 8, 16])
@pytest.mark.parametrize("case,kw", TRI_MODEL_CASES,
                         ids=[_case_id(("", 0, c, kw)) for c, kw in
                              TRI_MODEL_CASES])
def test_triangulate_insert_cluster_model_is_the_plain_version(case, kw, c):
    """csrc/track.cu's triangulate_insert_kernel as a numpy model over a
    cluster of c blocks against triangulate_insert_plain, stream by stream,
    every output equal, NaN for NaN (degenerate pairs)."""
    kw = dict(SMALL, **kw) if set(kw) <= {"rgbd", "policy",
                                          "staged_threshold"} else kw
    args = _track_problem(np.random.RandomState(c), "triangulate_insert", 2,
                          "cpu", case, **kw)
    want = _track_plain("triangulate_insert", args)
    for i in range(2):
        a = [x[i] if isinstance(x, torch.Tensor) else x for x in args]
        got = _tri_model(a, c)
        assert len(got) == len(want)
        for g, w in zip(got, (x[i] for x in want)):
            np.testing.assert_array_equal(np.asarray(g), _np(w))


# ---- upkeep_pre_kernel's order (csrc/track.cu), modelled in numpy

UPKEEP_MODEL_CASES = [("random", {}), ("init", {}), ("random", {"n": 0}),
                      ("cull", {}),
                      ("cull", {"m": 3000, "k": 2048, "n": 2500})]


def _upkeep_model(a, threads):
    """upkeep_pre of one stream (the op's arguments, tensors) in
    upkeep_pre_kernel's order with a block of ``threads``: thread p holds
    map point p and staged point p (tile 0, loaded before the first
    barrier) and takes the later tiles of ``threads`` as they come; the
    un-marks set after the first barrier (the claim mask drops K); the kept
    count summed per thread, per warp, then over the warps' sums; every
    warp building the frame's pose and rotation itself and projecting its
    lanes' staged points with them."""
    (counter, age, valid, match_idx, fm, fvalid, t, q, is_init, spos,
     svalid), (thr, cam) = a[:11], a[11:]
    ctr, ag, v, idx = (_np(x) for x in (counter, age, valid, match_idx))
    m, k, n = ctr.shape[0], fm.shape[0], spos.shape[0]
    c_out, age_out = np.zeros_like(ctr), np.zeros_like(ag)
    v_out, unmark = np.zeros_like(v), np.zeros(k, bool)
    kept = np.zeros(threads, np.int64)
    for lo in range(0, m, threads):
        sl = slice(lo, min(m, lo + threads))
        c = ctr[sl] + (v[sl] & (idx[sl] < 0))
        remove = v[sl] & (c >= thr)
        c_out[sl], age_out[sl] = c, ag[sl] + (v[sl] & (idx[sl] >= 0))
        v_out[sl] = v[sl] & ~remove
        kept[:sl.stop - lo] += v_out[sl]
        um = np.where(remove & (idx[sl] >= 0) & (idx[sl] < k), idx[sl], -1)
        unmark[um[um >= 0]] = True
    size = kept.reshape(-1, 32).sum(1).sum()
    cam = dict(zip(track.CAM_KEYS, cam))
    uv = torch.zeros((n, 2))
    vis = torch.zeros(n, dtype=torch.bool)
    for w in range(threads // 32):
        pose = track.select(is_init, Pose.identity(), Pose(t, q))
        lanes = (np.arange(32 * w, 32 * (w + 1))[None]
                 + np.arange(0, n, threads)[:, None]).ravel()
        lanes = torch.from_numpy(lanes[lanes < n])
        uv[lanes], vis[lanes] = matching.project_visible(
            spos[lanes], svalid[lanes], pose, **cam)
    fm_out = _np(fm) & ~unmark
    return (c_out, age_out, v_out, fm_out, _np(fvalid) & ~fm_out,
            np.int64(size), _np(torch.cat(list(pose))), _np(uv), _np(vis))


@pytest.mark.parametrize("threads", [1024, 64])
@pytest.mark.parametrize("case,kw", UPKEEP_MODEL_CASES,
                         ids=[_case_id(("", 0, c, kw)) for c, kw in
                              UPKEEP_MODEL_CASES])
def test_upkeep_pre_kernel_model_is_the_plain_version(case, kw, threads):
    """csrc/track.cu's upkeep_pre_kernel as a numpy model (tiles of a
    block's threads, the un-marks after the first barrier, the kept count
    by warps, the pose per warp) against upkeep_pre_plain, stream by
    stream, every output equal; ``cull`` puts counters about the
    threshold, so points culled at it hold features, and the tiles at 64
    threads (and past 1024 points) run several passes of both axes."""
    args = _track_problem(np.random.RandomState(threads), "upkeep_pre", 2,
                          "cpu", case, **kw)
    want = _track_plain("upkeep_pre", args)
    culled_holding = at_threshold = 0
    for i in range(2):
        a = [x[i] if isinstance(x, torch.Tensor) else x for x in args]
        got = _upkeep_model(a, threads)
        assert len(got) == len(want)
        for g, w in zip(got, (x[i] for x in want)):
            np.testing.assert_array_equal(np.asarray(g), _np(w))
        culled = _np(a[2]) & ~got[2]
        culled_holding += int((culled & (_np(a[3]) >= 0)).sum())
        at_threshold += int((culled & (got[0] == a[11])).sum())
    if case == "cull":
        assert culled_holding > 0 and at_threshold > 0
    if case == "init":
        np.testing.assert_array_equal(_np(want[6][0]), [0, 0, 0, 1, 0, 0, 0])
