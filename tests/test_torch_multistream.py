"""lvt_tpu_torch's multi-stream mode (parallel/multistream.py) against
lvt_tpu's and against the port's own single-stream step, on the CPU, and
kernel T's batching rule.

The worlds are tests/test_parallel.py's 192x144 ones: stream 0 sees world
A, stream 1 world B (another seed, speed and yaw), so the streams carry
different content. The JAX side runs as the JAX tests run it on the CPU
(patch mode through XLA, no Pallas kernels, no MXU Hamming). Tolerances:
  * the batched initial state: shapes and values equal;
  * against lvt_tpu's jitted ``multistream_step_stereo`` over 4 frames:
    statuses and tracked map points equal per stream, poses within
    1e-3 m (test_torch_system.py's bound for the jitted JAX step, whose
    fused multiply-adds move poses by ~1e-4 m);
  * against the port's single-stream ``VOSystem`` per stream: patch mode,
    BA off, 5 frames bit-equal (PnP's reductions are the ops
    ``lvt_tpu_torch::pnp_normal_eqs`` and ``stream_sum``, each stream
    summed on its own) with equal statuses and match counts;
    dense mode with BA (window 4 every 4), 9 frames within 1e-3 m with BA
    on the same frames (vmapped reductions may sum in another order, and
    BA's accept tests amplify that, as on the card: ROADMAP H7);
  * ``track_chunk`` against N ``track`` calls, with auto-reset: equal;
  * a stream blanked for a frame: statuses equal lvt_tpu's MultiStreamVO
    frame by frame;
  * no op of the vmapped step falls back to vmap's per-sample loop;
  * kernel T's vmap rule: bit-equal to a loop of its plain version.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.config import VOConfig
from lvt_tpu.io.synthetic import SyntheticWorld
from lvt_tpu.parallel import multistream as jx_ms
from lvt_tpu_torch import convert
from lvt_tpu_torch.core.state import LOST, NOT_INITIALIZED, TRACKING
from lvt_tpu_torch.core.system import VOSystem
from lvt_tpu_torch.ops import top2
from lvt_tpu_torch.parallel import multistream as ms
from lvt_tpu_torch.tree import flatten_with_path
from tests.test_torch_system import share_the_cores  # noqa: F401

WORLD = dict(width=192, height=144, fx=160.0, fy=160.0, cx=96.0, cy=72.0,
             baseline=0.25, n_points=900, extent_x=25.0, extent_y=12.0,
             extent_z=50.0)


def _config(**kw) -> VOConfig:
    w = SyntheticWorld(**WORLD)
    return VOConfig(
        fx=w.fx, fy=w.fy, cx=w.cx, cy=w.cy, baseline=w.baseline,
        img_width=w.width, img_height=w.height, detection_cell_size=64,
        max_keypoints_per_cell=40, agast_threshold=12,
        near_plane_distance=0.5, far_plane_distance=80.0,
        max_map_points=512, max_staged_points=512, descriptor_mode="patch",
        use_pallas_perception=False, use_pallas_matching=False,
        use_mxu_hamming=False).replace(**kw)


def _u8(x):
    return np.clip(x, 0, 255).astype(np.uint8)


def divergent_frames(n):
    """[n, 2, H, W] uint8 left and right: stream 0 world A, stream 1 B."""
    a = SyntheticWorld(**WORLD).stereo_sequence(n, speed=0.3)
    b = SyntheticWorld(**dict(WORLD, seed=99)).stereo_sequence(
        n, speed=0.45, yaw_rate=0.01)
    frames = list(zip(a, b))
    left = np.stack([[_u8(fa[0]), _u8(fb[0])] for fa, fb in frames])
    right = np.stack([[_u8(fa[1]), _u8(fb[1])] for fa, fb in frames])
    return left, right


@pytest.fixture(scope="module")
def frames9():
    return divergent_frames(9)


def test_batched_initial_state_matches_lvt_tpus():
    cfg = _config(local_ba_window=4)
    ours = ms.batched_initial_state(cfg, 3, device="cpu")
    theirs = jx_ms.batched_initial_state(cfg, 3)
    assert ours.map.pos.shape == (3, 512, 3) and ours.status.shape == (3,)
    assert ours.ba.obs.shape == (3, 4, 512, 2)
    for (key, a), (_, b) in zip(
            flatten_with_path(convert.to_numpy(ours)),
            flatten_with_path(jax.tree.map(np.asarray, theirs))):
        assert a.shape == b.shape and a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    # a JAX batched state crosses into the port and back unchanged
    back = convert.to_numpy(convert.to_port(theirs, "cpu"))
    for (key, a), (_, b) in zip(
            flatten_with_path(back),
            flatten_with_path(jax.tree.map(np.asarray, theirs))):
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)


def test_reset_lost_streams_resets_only_the_lost_slice():
    cfg = _config()
    st = ms.batched_initial_state(cfg, 3, device="cpu")
    st = st._replace(
        status=torch.tensor([TRACKING, LOST, TRACKING], dtype=torch.int32),
        frame_number=torch.tensor([5, 5, 5], dtype=torch.int32),
        pose=st.pose._replace(t=torch.arange(9.0).reshape(3, 3)),
        map=st.map._replace(valid=torch.ones(3, 512, dtype=torch.bool)))
    out = ms.reset_lost_streams(st, cfg)
    assert out.status.tolist() == [TRACKING, NOT_INITIALIZED, TRACKING]
    assert out.frame_number.tolist() == [5, 0, 5]
    assert out.map.size().tolist() == [512, 0, 512]
    assert torch.equal(out.pose.t, st.pose.t)       # the pose is kept


@pytest.mark.parametrize("statuses", [(LOST, TRACKING, NOT_INITIALIZED),
                                      (TRACKING, LOST, LOST)])
def test_the_runners_reset_is_lvt_tpus_reset_lost(statuses):
    """The reset that ends a MultiStreamVO frame where the tail did not
    (``Epilogue.finish``: ``tail.reset_lost``, which csrc/tail.cu folds
    into the tail's launch on the card) against lvt_tpu's ``_reset_lost``
    on a state of random leaves whose streams are lost, tracking and
    init: every leaf equal; a lost stream's pose kept."""
    from lvt_tpu_torch.core import graphs, tail
    from lvt_tpu_torch.tree import from_leaves, leaves, tree_map

    cfg = _config(local_ba_window=2)
    rs = np.random.RandomState(len(statuses) + statuses[0])
    base = ms.batched_initial_state(cfg, 3, device="cpu")
    new = tree_map(lambda x: torch.from_numpy(
        (rs.rand(*x.shape) * 9).astype(x.numpy().dtype)), base)
    new = new._replace(status=torch.tensor(statuses, dtype=torch.int32))
    buffers = tree_map(torch.zeros_like, base)
    fresh = from_leaves(base, [x[0].clone() for x in leaves(base)])
    epilogue = graphs.Epilogue(buffers, [], reset=fresh, chunked=False)
    epilogue.finish(new, None, None)
    theirs = jax.tree.structure(jx_ms.batched_initial_state(cfg, 3))
    want = jx_ms._reset_lost(jax.tree.unflatten(theirs, [
        jnp.asarray(x) for x in leaves(convert.to_numpy(new))]), cfg)
    for (key, a), (_, b) in zip(flatten_with_path(convert.to_numpy(buffers)),
                                flatten_with_path(jax.tree.map(np.asarray,
                                                               want))):
        np.testing.assert_array_equal(a, b, err_msg=key)
    lost = [i for i, st in enumerate(statuses) if st == LOST]
    assert torch.equal(buffers.pose.t[lost], new.pose.t[lost])
    assert (buffers.status[lost] == NOT_INITIALIZED).all()
    assert torch.equal(tail.reset_lost(new, fresh).map.pos, buffers.map.pos)


def test_multistream_step_matches_lvt_tpu(frames9):
    left, right = frames9
    cfg = _config()
    st = ms.batched_initial_state(cfg, 2, device="cpu")
    jst = jx_ms.batched_initial_state(cfg, 2)
    for i in range(4):
        st, pose, m = ms.multistream_step_stereo(
            st, torch.from_numpy(left[i]), torch.from_numpy(right[i]), cfg)
        jst, jpose, jm = jx_ms.multistream_step_stereo(
            jst, jnp.asarray(left[i]), jnp.asarray(right[i]), cfg)
        for name in ("status", "tracked_map_points"):
            np.testing.assert_array_equal(getattr(m, name).numpy(),
                                          np.asarray(getattr(jm, name)),
                                          err_msg=f"frame {i} {name}")
        np.testing.assert_allclose(pose.t.numpy(), np.asarray(jpose.t),
                                   atol=1e-3, err_msg=f"frame {i}")
    assert (m.status.numpy() == TRACKING).all()
    assert (m.tracked_map_points.numpy() > 50).all()
    # the two streams tracked different trajectories
    assert float((pose.t[0] - pose.t[1]).norm()) > 0.1


@pytest.mark.parametrize("mode", ["patch", "dense_ba"])
def test_multistream_matches_single_stream(frames9, mode):
    left, right = frames9
    if mode == "patch":
        cfg, n, atol = _config(), 5, 1e-4
    else:
        cfg, n, atol = _config(descriptor_mode="dense", local_ba_window=4,
                               local_ba_every=4), 9, 1e-3
    msvo = ms.MultiStreamVO(cfg, 2, device="cpu", auto_reset=False)
    singles = [VOSystem(cfg, device="cpu") for _ in range(2)]
    ba = []
    for i in range(n):
        poses, m = msvo.track(left[i], right[i])
        for s, vo in enumerate(singles):
            p = vo.track(left[i, s], right[i, s])
            lm = vo.last_metrics
            np.testing.assert_allclose(poses.t[s].numpy(), p.t.numpy(),
                                       atol=atol, err_msg=f"frame {i}/{s}")
            if mode == "patch":
                assert torch.equal(poses.t[s], p.t), f"frame {i}/{s}"
                assert torch.equal(poses.q[s], p.q), f"frame {i}/{s}"
            assert int(m.status[s]) == int(lm.status)
            assert bool(m.local_ba_ran[s]) == bool(lm.local_ba_ran)
            if mode == "patch":
                assert int(m.tracked_map_points[s]) == int(
                    lm.tracked_map_points)
        ba.append(m.local_ba_ran.numpy())
    assert (msvo.status == TRACKING).all()
    if mode == "dense_ba":
        # BA ran at frames 4 and 8 in both streams
        np.testing.assert_array_equal(np.array(ba).T, np.stack(
            [np.isin(np.arange(n), [4, 8])] * 2))


def test_track_chunk_equals_track_calls(frames9):
    left, right = frames9
    left = np.concatenate([left, left[:, :1]], axis=1)[:5]    # S = 3
    right = np.concatenate([right, right[:, :1]], axis=1)[:5]
    cfg = _config()
    a = ms.MultiStreamVO(cfg, 3, device="cpu")
    b = ms.MultiStreamVO(cfg, 3, device="cpu")
    poses, metrics = a.track_chunk(left, right)
    assert poses.t.shape == (5, 3, 3) and metrics.status.shape == (5, 3)
    for i in range(5):
        p, m = b.track(left[i], right[i])
        assert torch.equal(p.t, poses.t[i]) and torch.equal(p.q, poses.q[i])
        assert torch.equal(m.status, metrics.status[i])
    np.testing.assert_array_equal(a.status, b.status)
    for (key, x), (_, y) in zip(flatten_with_path(a.states),
                                flatten_with_path(b.states)):
        assert torch.equal(x, y), key


def test_lost_stream_resets_without_stalling_the_batch():
    """Stream 1 blanked at frame 2: LOST that frame, reset to
    NOT_INITIALIZED with its pose kept, TRACKING again after; the other
    streams never leave TRACKING; every frame's statuses equal
    lvt_tpu's MultiStreamVO's."""
    cfg = _config()
    world = SyntheticWorld(**WORLD)
    s = 4
    ours = ms.MultiStreamVO(cfg, s, device="cpu", auto_reset=True)
    theirs = jx_ms.MultiStreamVO(cfg, s, auto_reset=True)
    for i, (img_l, img_r, _) in enumerate(world.stereo_sequence(4, speed=0.3)):
        il = np.stack([_u8(img_l)] * s)
        ir = np.stack([_u8(img_r)] * s)
        if i == 2:
            il[1] = 50
            ir[1] = 50
        # a copy: the states are static buffers that track overwrites
        before = ours.states.pose._replace(t=ours.states.pose.t.clone(),
                                           q=ours.states.pose.q.clone())
        _, m = ours.track(il, ir)
        _, jm = theirs.track(il, ir)
        np.testing.assert_array_equal(m.status.numpy(), np.asarray(jm.status))
        np.testing.assert_array_equal(ours.status, theirs.status)
        assert (ours.status[[0, 2, 3]] == TRACKING).all()
        if i == 2:
            assert int(m.status[1]) == LOST
            assert ours.status[1] == NOT_INITIALIZED
            assert torch.equal(ours.states.pose.t[1], before.t[1])
            assert torch.equal(ours.states.pose.q[1], before.q[1])
            assert int(ours.states.map.size()[1]) == 0
    assert (ours.status == TRACKING).all()


@pytest.mark.parametrize("mode", ["stereo", "stereo_dense_ba", "rgbd"])
def test_no_vmap_fallback_in_the_step(mode):
    """Every op of the vmapped step has a batching rule: with vmap's
    fallback warning on, one batched step (init) and one tracking step
    warn nothing."""
    cfg = _config()
    world = SyntheticWorld(**WORLD)
    if mode == "rgbd":
        seq = [(_u8(g), d.astype(np.float32))
               for g, d, _ in world.rgbd_sequence(2, speed=0.3)]
    else:
        seq = [(_u8(a), _u8(b))
               for a, b, _ in world.stereo_sequence(2, speed=0.3)]
        if mode == "stereo_dense_ba":
            cfg = cfg.replace(descriptor_mode="dense", local_ba_window=2,
                              local_ba_every=1)
    msvo = ms.MultiStreamVO(cfg, 2, device="cpu", rgbd=mode == "rgbd")
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for a, b in seq:
                msvo.track(np.stack([a, a]), np.stack([b, b]))
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    fallbacks = [str(w.message) for w in caught
                 if "batching rule" in str(w.message)]
    assert not fallbacks, fallbacks
    assert (msvo.status == TRACKING).all()


@pytest.mark.parametrize("mode", ["dual", "single", "row", "row_dual"])
@pytest.mark.parametrize("unbatched", [None, 1, 4])
def test_top2_vmap_rule_matches_a_loop_of_plain(mode, unbatched):
    """vmap of the single-stream kernel T call over 3 streams (one
    argument unbatched where ``unbatched`` names it) against
    hamming_top2_plain stream by stream: bit-equal (row modes: the
    keypoints, the exclusion and, dual, the second set batched too)."""
    rs = np.random.RandomState(5)
    s, m, k = 3, 45, 70
    q_desc = rs.randint(-2**31, 2**31 - 1, (s, m, 8)).astype(np.int32)
    t_desc = rs.randint(-2**31, 2**31 - 1, (s, k, 8)).astype(np.int32)
    t_desc[:, 1::3] = t_desc[:, ::3][:, :t_desc[:, 1::3].shape[1]]
    t_kp = rs.uniform(0, 60, (s, k, 2)).astype(np.float32)
    q_meta = rs.uniform(0, 60, (s, m, 2)).astype(np.float32)
    sets = []
    if mode.startswith("row"):
        kw = dict(row_mode=True, row_radius=2.0, img_rows=60.0)
        sets = [rs.rand(s, m) > 0.6] + [rs.rand(s, m) > 0.5] * (
            mode == "row_dual")
    else:
        kw = dict(r2a=12.0**2, r2b=(24.0 if mode == "dual" else 12.0)**2)
    args = [torch.from_numpy(a) for a in (
        q_desc, t_desc, q_meta, rs.rand(s, m) > 0.1, t_kp,
        rs.rand(s, k) > 0.1, *sets)]
    in_dims = [0] * len(args)
    if unbatched is not None:
        in_dims[unbatched] = None
        args[unbatched] = args[unbatched][0]
    got = torch.func.vmap(lambda *a: top2.hamming_top2(*a, **kw),
                          in_dims=tuple(in_dims))(*args)
    full = [a if d == 0 else a.expand(s, *a.shape)
            for a, d in zip(args, in_dims)]
    want = top2.hamming_top2_plain_batched(*full, **kw)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and torch.equal(a, b)
    # the batched call without vmap: the same bits
    for g, w in zip(top2.hamming_top2_batched(*[x.contiguous() for x in full],
                                              **kw), want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)
