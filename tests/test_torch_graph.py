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
  * the mode rule: exact;
  * the functional chunk API through a caller's runner cache, in two
    chunks, against ``VOSystem.track_chunk``: bit-equal, one runner;
  * a graph dropped while a capture runs is kept until it ends: exact.
"""

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
    for a, b in zip(graphs._leaves(vo.state), graphs._leaves(evo.state)):
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
        runner.replay(torch.zeros(3))
    with pytest.raises(ValueError, match="frame input"):
        runner.replay(torch.zeros(2, dtype=torch.uint8))


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
