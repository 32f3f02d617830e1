"""lvt_tpu_torch's runner of the tracking step (core/graphs.py) on the CPU:
the entry points through their runners against lvt_tpu, the eager step,
the copies they return, and the rule that picks graph or eager.

On the CPU a runner always calls the step eagerly on its static buffers
(frame copied in, new state copied back); these tests exercise that
plumbing, and tests/test_torch_cuda.py holds the captured graph against
the eager step on the card. The JAX side runs as the JAX tests run it on
the CPU (patch mode through XLA, no Pallas kernels). Tolerances:
  * VOSystem over chunks of 8, 3 and 1 frames, with a ``reset`` and a
    ``load_checkpoint`` (lvt_tpu's state) between them, against lvt_tpu's
    ``VOSystem.track_chunk`` on the same frames: poses within 1e-3 m
    (tests/test_torch_system.py's bound for the jitted JAX step), statuses
    equal;
  * the same run under ``disable_graphs()``: bit-equal;
  * MultiStreamVO with a stream blanked for a frame (lost, then reset in
    the chunk) against lvt_tpu's MultiStreamVO.track_chunk: statuses
    equal, poses within 1e-3 m;
  * the mode rule, and the rule that makes lvt_tpu's ``lax.cond`` (local
    BA) a CUDA IF node only in a captured step that is not vmapped:
    exact;
  * the BA helper's selected form (core/step.py::_local_ba_update) against
    lvt_tpu's ``lax.cond`` form on the inputs of 9 frames of path 2's
    config: the window and the BA predicate equal, the map bit-equal on
    frames without BA; on BA frames tests/test_torch_bundle.py's BA
    tolerance (the writeback decided alike for all but 1% of the points,
    points refined by both within 1e-2 m);
  * the functional chunk API through a caller's runner cache, in two
    chunks, against ``VOSystem.track_chunk``: bit-equal, one runner;
  * a graph dropped while a capture runs is kept until it ends: exact.
"""

import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lvt_tpu.core.system import VOSystem as JxVOSystem
from lvt_tpu.parallel import multistream as jx_ms
from lvt_tpu_torch.core import graphs
from lvt_tpu_torch.core.state import LOST, TRACKING
from lvt_tpu_torch.core.system import TrackingState, VOSystem
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.parallel import multistream as ms
from lvt_tpu_torch.tree import leaves
from tests.test_torch_multistream import _config as ms_config
from tests.test_torch_multistream import divergent_frames
from tests.test_torch_system import _config, _world
from tests.test_torch_system import share_the_cores  # noqa: F401

CHUNKS = (8, 3, 1)


@pytest.fixture(scope="module")
def frames():
    world = _world()
    seq = [(l.astype(np.uint8), r.astype(np.uint8))
           for l, r, _ in world.stereo_sequence(sum(CHUNKS), speed=0.5)]
    return (_config(world), np.stack([f[0] for f in seq]),
            np.stack([f[1] for f in seq]))


@pytest.fixture(scope="module")
def runs(frames, tmp_path_factory):
    """lvt_tpu's VOSystem and the port's over chunks of 8, 3 and 1 frames,
    a reset after the first, lvt_tpu's state loaded after the second; the
    port also keeps ``last_pose`` read after the first chunk, and copies
    of it and of the first chunk's poses made then. Under
    ``disable_graphs()`` a second port system runs the chunks after the
    reset (which start over, as a new system does)."""
    cfg, il, ir = frames
    jvo = JxVOSystem(cfg)
    jout = [jvo.track_chunk(il[:8], ir[:8])]
    jvo.reset()
    jout.append(jvo.track_chunk(il[8:11], ir[8:11]))
    ckpt = str(tmp_path_factory.mktemp("graph") / "lvt_tpu_state.npz")
    jvo.save_checkpoint(ckpt)
    jout.append(jvo.track_chunk(il[11:], ir[11:]))

    def after_reset(vo):
        out = vo.track_chunk(il[8:11], ir[8:11])
        vo.load_checkpoint(ckpt)
        return out, vo.track(il[11], ir[11])

    vo = VOSystem(cfg, device="cpu")
    out = [vo.track_chunk(il[:8], ir[:8])]
    first_last = vo.last_pose
    kept = [tuple(x.clone() for x in out[0][0]),
            tuple(x.clone() for x in first_last)]
    vo.reset()
    chunk, pose = after_reset(vo)
    with graphs.disable_graphs():
        evo = VOSystem(cfg, device="cpu")
        eager = (evo, *after_reset(evo))
    return jout, (vo, out + [chunk], pose, first_last, kept), eager


def test_chunks_with_reset_and_checkpoint_match_lvt_tpu(runs):
    jout, (vo, out, pose, _, _), _ = runs
    out = out + [(type(pose)(pose.t[None], pose.q[None]),
                  vo.last_metrics._replace(status=vo.last_metrics.status[None]))]
    for n, (p, m), (jp, jm) in zip(CHUNKS, out, jout):
        assert p.t.shape == (n, 3)
        np.testing.assert_allclose(p.t.numpy(), np.asarray(jp.t), atol=1e-3)
        np.testing.assert_allclose(p.q.numpy(), np.asarray(jp.q), atol=1e-3)
        np.testing.assert_array_equal(m.status.numpy(), np.asarray(jm.status))
    assert vo.get_state() == TrackingState.TRACKING
    # the reset started the second chunk over, at the identity pose
    assert torch.equal(out[1][0].t[0], torch.zeros(3))


def test_disable_graphs_runs_the_same_step(runs):
    _, (vo, out, pose, _, _), (evo, (ep, em), epose) = runs
    p, m = out[1]
    for a, b in zip([*p, *m], [*ep, *em]):
        assert torch.equal(a, b)
    assert torch.equal(pose.t, epose.t) and torch.equal(pose.q, epose.q)
    for a, b in zip(leaves(vo.state), leaves(evo.state)):
        assert torch.equal(a, b)


def test_results_are_copies_later_frames_leave_alone(runs):
    """The poses of the first chunk and ``last_pose`` read after it are
    unchanged by the reset, the checkpoint and the frames after them;
    ``track``'s pose is not the state's buffer."""
    _, (vo, out, pose, first_last, kept), _ = runs
    poses, _ = out[0]
    for got, want in zip((poses, first_last), kept):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert not torch.equal(first_last.t, vo.state.pose.t)
    assert pose.t.untyped_storage().data_ptr() != \
        vo.state.pose.t.untyped_storage().data_ptr()
    last = vo.last_pose
    vo.state.pose.t.add_(1.0)
    assert not torch.equal(last.t, vo.state.pose.t)


def test_multistream_chunk_with_a_reset_matches_lvt_tpu():
    cfg = ms_config()
    left, right = divergent_frames(4)
    left[2, 1] = 50           # stream 1 sees a blank frame: lost, then reset
    right[2, 1] = 50
    ours = ms.MultiStreamVO(cfg, 2, device="cpu")
    theirs = jx_ms.MultiStreamVO(cfg, 2)
    p, m = ours.track_chunk(left, right)
    jp, jm = theirs.track_chunk(left, right)
    np.testing.assert_array_equal(m.status.numpy(), np.asarray(jm.status))
    assert int(m.status[2, 1]) == LOST and int(m.status[3, 1]) == TRACKING
    np.testing.assert_allclose(p.t.numpy(), np.asarray(jp.t), atol=1e-3)
    np.testing.assert_array_equal(ours.status, theirs.status)
    # the step and the reset went through one runner
    (runner,) = ours.runners.values()
    assert runner.mode == "eager" and runner.state is ours.states


def test_mode_rule(tmp_path, monkeypatch):
    """Graph on CUDA without a group or with an NCCL one; eager on the
    CPU, on a gloo group and inside ``disable_graphs``; decided without
    touching a device."""
    assert graphs.capturable(torch.device("cuda"))
    assert not graphs.capturable(torch.device("cpu"))
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                                rank=0, world_size=1)
        made = True
    else:
        made = False
    try:
        group = dist.group.WORLD
        assert not graphs.capturable("cuda", group)
        with monkeypatch.context() as m:
            m.setattr(dist, "get_backend", lambda group=None: "nccl")
            assert graphs.capturable("cuda", group)
    finally:
        if made:
            dist.destroy_process_group()

    runner = graphs.StepGraph(lambda st, x: (st, x, x),
                              Pose.identity("cpu"), [torch.zeros(2)])
    assert runner.mode == "eager" and not runner.capturable
    runner.capturable = True          # as on the card
    assert runner.mode == "graph"
    with graphs.disable_graphs():
        assert runner.mode == "eager"
        with graphs.disable_graphs():
            assert graphs.graphs_disabled()
        assert runner.mode == "eager"
    assert runner.mode == "graph" and not graphs.graphs_disabled()


def test_runner_refuses_a_frame_of_another_shape():
    runner = graphs.StepGraph(lambda st, x: (st, x, x),
                              Pose.identity("cpu"), [torch.zeros(2)])
    with pytest.raises(ValueError, match="frame input"):
        runner.run(torch.zeros(1, 3))
    with pytest.raises(ValueError, match="frame input"):
        runner.run(torch.zeros(1, 2, dtype=torch.uint8))


@pytest.mark.parametrize("sizes", [(1,), (3, 1), (2, 4)])
def test_a_chunk_starts_once_then_each_frame_is_one_step(sizes):
    """The runner's contract on the CPU, with a step that is not the VO
    step (so its frame ends in ``Epilogue.finish``): a chunk of N frames
    is one start (frame 0 in the input buffer, the counter at 0) and N
    calls of the step, each on the frame the previous one left in the
    buffer; row i of the chunk's new tensors holds frame i's outputs; the
    counter reads N after the chunk, and the buffer the chunk's last
    frame. The next chunk starts over."""
    calls = []

    def step(state, x):
        calls.append(x.clone())
        return (state._replace(t=state.t + x[:3], q=state.q.flip(0)),
                x * 2, x.sum())

    state = Pose(torch.zeros(3), torch.arange(4.0))
    runner = graphs.StepGraph(step, state, [torch.zeros(5)],
                              outputs=(torch.zeros(5), torch.zeros(())))
    total = torch.zeros(3)
    for n in sizes:
        calls.clear()
        xs = torch.randn(n, 5)
        doubled, sums = runner.run(xs)
        assert [torch.equal(c, x) for c, x in zip(calls, xs)] == [True] * n
        assert len(calls) == n
        assert torch.equal(doubled, xs * 2) and doubled is not xs
        assert torch.equal(sums, xs.sum(1))
        assert int(runner.epilogue.counter) == n
        assert torch.equal(runner.inputs[0], xs[-1])
        total += xs[:, :3].sum(0)
        assert torch.allclose(state.t, total)
    assert torch.equal(state.q, torch.arange(4.0).flip(0) if sum(sizes) % 2
                       else torch.arange(4.0))


def test_copy_into_reads_every_source_before_writing():
    """A new state whose leaves are the old state's leaves in another
    order (a swap) lands whole: no buffer is read after it was written."""
    a, b = torch.tensor([1.0]), torch.tensor([2.0])
    graphs.copy_into(Pose(a, b), Pose(b, a))
    assert (float(a), float(b)) == (2.0, 1.0)


def test_chunk_functions_run_through_the_callers_runners(frames):
    """The functional chunk API runs through the runner cache it is given:
    one runner per entry point, reused by later chunks, writing the given
    state in place; the result is VOSystem.track_chunk's."""
    from lvt_tpu_torch.core import step

    cfg, il, ir = frames
    a, b = torch.from_numpy(il[:3]), torch.from_numpy(ir[:3])
    state, runners = VOSystem(cfg, device="cpu").state, {}
    first = step.track_chunk_stereo(state, a[:2], b[:2], cfg, runners)
    (runner,) = runners.values()
    second = step.track_chunk_stereo(state, a[2:], b[2:], cfg, runners)
    assert list(runners.values()) == [runner] and runner.state is state
    assert first[0] is state and second[0] is state
    poses, metrics = VOSystem(cfg, device="cpu").track_chunk(a, b)
    assert torch.equal(torch.cat([first[1].t, second[1].t]), poses.t)
    assert torch.equal(torch.cat([first[2].status, second[2].status]),
                       metrics.status)


@pytest.mark.parametrize("capturing", [True, False])
def test_a_graph_dropped_during_a_capture_outlives_it(monkeypatch, capturing):
    """A runner dropped while a capture runs (on any thread) hands its
    graph to ``_dropped``, which the capture clears when it ends; with no
    capture running the graph goes with the runner."""
    monkeypatch.setattr(graphs, "_capturing", capturing)
    monkeypatch.setattr(graphs, "_dropped", [])
    runner = graphs.StepGraph(lambda st, x: (st, x, x),
                              Pose.identity("cpu"), [torch.zeros(2)])
    graph = runner._graph = object()      # stands for a captured graph
    del runner
    assert graphs._dropped == ([graph] if capturing else [])


def test_a_runner_finalized_under_the_drop_lock_does_not_wait_for_it():
    """A runner whose last reference goes on a thread that holds
    ``_dropped_lock`` (as when the collector runs inside a capture's
    clean-up) is finalized there instead of waiting for the lock forever."""
    def drop():
        runner = graphs.StepGraph.__new__(graphs.StepGraph)
        runner._graph, runner._branches = object(), []
        with graphs._dropped_lock:
            del runner

    worker = threading.Thread(target=drop, daemon=True)
    worker.start()
    worker.join(10)
    assert not worker.is_alive()


def test_ba_cond_rule(tmp_path, monkeypatch):
    """lvt_tpu's ``lax.cond`` (local BA on its schedule) is a CUDA IF node
    only in a captured step that is not vmapped: a single-process graph on
    the card, or one on an NCCL group; the select on the CPU (the eager
    step), on a gloo group and under vmap (MultiStreamVO's runners are
    made batched, VOSystem's not). Decided without touching a device;
    outside a capture ``graphs.cond`` is the select."""
    assert graphs.if_nodes(torch.device("cuda"))
    assert not graphs.if_nodes("cuda", batched=True)
    assert not graphs.if_nodes(torch.device("cpu"))
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                                rank=0, world_size=1)
        made = True
    else:
        made = False
    try:
        group = dist.group.WORLD
        assert not graphs.if_nodes("cuda", group)
        with monkeypatch.context() as m:
            m.setattr(dist, "get_backend", lambda group=None: "nccl")
            assert graphs.if_nodes("cuda", group)
            assert not graphs.if_nodes("cuda", group, batched=True)
    finally:
        if made:
            dist.destroy_process_group()

    made_batched = []
    real = graphs.if_nodes
    monkeypatch.setattr(graphs, "if_nodes",
                        lambda device, group=None, *, batched=False: (
                            made_batched.append(batched)
                            or real(device, group, batched=batched)))
    cfg = ms_config(local_ba_window=4)
    left, right = divergent_frames(1)
    VOSystem(cfg, device="cpu").track(left[0, 0], right[0, 0])
    ms.MultiStreamVO(cfg, 2, device="cpu").track(left[0], right[0])
    assert made_batched == [False, True]

    calls = []
    pos = torch.arange(6.0).reshape(2, 3)
    run = lambda: calls.append(1) or pos + 1  # noqa: E731
    for pred in (True, False):
        got = graphs.cond(torch.tensor(pred), run, pos)
        assert torch.equal(got, pos + 1 if pred else pos)
    assert calls == [1, 1]


def test_local_ba_update_matches_lvt_tpu():
    """The BA helper's selected form (core/step.py::_local_ba_update, as
    the eager step, the warm-up and a vmapped step run it) against
    lvt_tpu's ``lax.cond`` form on the same inputs: the ones the port's
    step gave it over frames 0-8 of a KITTI-geometry sequence, with path
    2's config (the shipped KITTI YAML in dense mode: window 4, BA every 4
    frames, so BA at frames 4 and 8); lvt_tpu's takes the right
    observations that its step gathers from the BA row match's top-2 (the
    port's kernel T output, ``jx_ba_observations``) and the slots the
    masks invalidate. The window, its newest pose and the
    BA predicate equal; the map positions bit-equal on the other frames;
    on BA frames, tests/test_torch_bundle.py's tolerance for BA (its sums
    are float64 here, float32 in lvt_tpu): the writeback decided alike for
    all but 1% of the points either side refined, and points refined by
    both within 1e-2 m."""
    import jax
    import jax.numpy as jnp

    from lvt_tpu.config import VOConfig as JxVOConfig
    from lvt_tpu.core import step as jx_step
    from lvt_tpu_torch import configs, convert
    from lvt_tpu_torch.core import step
    from lvt_tpu_torch.io.synthetic import SyntheticWorld
    from lvt_tpu_torch.ops import top2
    from lvt_tpu_torch.tree import tree_map
    from tests.test_torch_ba_refine import jx_ba_observations

    cfg = configs.kitti_ba_dense_config()
    world = SyntheticWorld(width=cfg.img_width, height=cfg.img_height,
                           fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy,
                           baseline=cfg.baseline, n_points=6000,
                           extent_x=80.0, extent_y=20.0, extent_z=160.0)
    seq = list(world.stereo_sequence(9, speed=0.9))
    calls = []
    real = step._local_ba_update

    def record(*args):
        # the state's leaves are the runner's buffers, rewritten later
        calls.append([None if a is None
                      else tuple(map(torch.clone, a)) if type(a) is tuple
                      else tree_map(torch.clone, a) for a in args[:-2]])
        return real(*args)

    import unittest.mock

    with unittest.mock.patch.object(step, "_local_ba_update", record):
        VOSystem(cfg, device="cpu").track_chunk(
            np.stack([f[0].astype(np.uint8) for f in seq]),
            np.stack([f[1].astype(np.uint8) for f in seq]))
    assert len(calls) == 9
    jcfg = JxVOConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    jx_update = jax.jit(jx_step._local_ba_update, static_argnums=9)
    ran = []
    for i, args in enumerate(calls):
        window, pose, pos, do_ba = real(*args, cfg)
        (ba, store, pose_opt, obs, w, row_packed, match_idx, right_kp,
         bookkept, clean, taken, promo, frame) = args
        obs_r, w_r = jx_ba_observations(
            top2._unpack(*row_packed)[1], match_idx, right_kp,
            cfg.triangulation_ratio_test_threshold,
            cfg.descriptor_matching_threshold)
        invalid = (bookkept & ~clean) | taken | promo
        jargs = [jax.tree.map(jnp.asarray, convert.to_numpy(a))
                 for a in (ba, store, pose_opt, obs, w)]
        jwindow, jpose, jpos = jx_update(
            *jargs, obs_r, w_r, jnp.asarray(invalid.numpy()),
            jnp.asarray(frame.numpy()), jcfg)
        for name, a, b in zip(window._fields, window, jwindow):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"frame {i} {name}")
        np.testing.assert_array_equal(pose.t.numpy(), np.asarray(jpose.t))
        np.testing.assert_array_equal(pose.q.numpy(), np.asarray(jpose.q))
        before = args[1].pos.numpy()
        pos, jpos = pos.numpy(), np.asarray(jpos)
        moved, jmoved = (pos != before).any(1), (jpos != before).any(1)
        ran.append(bool(do_ba))
        if not do_ba:
            np.testing.assert_array_equal(pos, before)
            np.testing.assert_array_equal(jpos, before)
            continue
        assert jmoved.sum() > 100, f"frame {i}"
        assert (moved != jmoved).sum() <= 0.01 * (moved | jmoved).sum()
        both = moved & jmoved
        np.testing.assert_allclose(pos[both], jpos[both], atol=1e-2)
    assert ran == [i in (4, 8) for i in range(9)]
