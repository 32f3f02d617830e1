"""The step's tail (lvt_tpu_torch/core/tail.py: ``step_tail_plain``, the
op ``lvt_tpu_torch::step_tail``, ``ordered_sum``) and the runner's copy
(core/graphs.py::copy_leaves) on the CPU, where the op is its plain
version stream by stream and the copy is ``copy_into`` (the CUDA kernels
of csrc/tail.cu are held against them in tests/test_torch_cuda.py).

Tolerances:
  * the plain tail against lvt_tpu's (the end of ``_track_branch`` and
    ``track_features``, under ``jax.jit`` on the inputs its own step gave
    it, captured from that trace) on an init frame, a tracking frame, a frame
    that loses track, a LOST frame and a local-BA frame: every state leaf,
    the pose, and every integer and bool metric bit-equal; the five means
    within rtol 1e-5 (``ordered_sum`` adds in a stated tree order,
    lvt_tpu's ``jnp.sum`` in XLA's; the second-distance mean takes in the
    no-candidate distance and reaches ~4e6, where one float32 step is 0.25
    and the two orders may part by a few steps);
  * ``ordered_sum`` against a numpy model of csrc/tail.cu's tree
    (registers, shared memory, the warp's shuffles), the op's CPU kernel
    and its vmap rule against the plain version per stream, and the copy:
    bit-equal.
"""

import collections

import jax
import numpy as np
import pytest
import torch

from lvt_tpu.core import map as jx_map
from lvt_tpu.core.features import FrameFeatures as JxFeatures
from lvt_tpu.core import step as jx_step
from lvt_tpu.core.state import VOState as JxState
from lvt_tpu.core.system import VOSystem as JxVOSystem
from lvt_tpu.ops import matching as jx_matching
from lvt_tpu_torch import convert
from lvt_tpu_torch.core import extract, graphs, tail
from lvt_tpu_torch.core.state import LOST, StepMetrics, VOState
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.tree import flatten_with_path, from_leaves, leaves
from tests.test_torch_cuda import (TAIL_MIN_MATCHES, _assert_outputs_equal,
                                   _tail_plain, _tail_stream, tail_problem)
from tests.test_torch_system import _config, _world
from tests.test_torch_system import share_the_cores  # noqa: F401

MEANS = ("mean_age", "mean_closest_descriptor_distance",
         "mean_second_descriptor_distance", "mean_feature_x",
         "mean_feature_y")


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _captor(cfg):
    """lvt_tpu's ``track_features`` on one frame under ``jax.jit`` (one
    compile per config and shape), returning besides its (state, pose,
    metrics) the tail's inputs as its trace computed them. The tail's
    selects are the trace's last ten ``_select`` calls (map, staged, pose,
    window, BA window, the pose out, the map count; then the three on
    LOST), the motion state the second."""
    seen = collections.defaultdict(list)

    def spy(name, fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            seen[name].append((a, out))
            return out
        return run

    def run(state, left, right):
        seen.clear()
        mp = pytest.MonkeyPatch()
        mp.setattr(jx_step, "_select", spy("select", jx_step._select))
        mp.setattr(jx_step, "solve_pnp", spy("pnp", jx_step.solve_pnp))
        mp.setattr(jx_matching, "find_map_matches",
                   spy("mm", jx_matching.find_map_matches))
        mp.setattr(jx_map, "insert_points",
                   spy("insert", jx_map.insert_points))
        try:
            out = jx_step.track_features(state, left, right, cfg,
                                         rgbd=False)
        finally:
            mp.undo()
        sel = seen["select"]
        (_, m_size, _), _ = sel[-4]
        (_, ba_new, _), _ = sel[-6]
        (_, window, _), _ = sel[-7]
        (_, pose, _), _ = sel[-8]
        (_, staged, _), _ = sel[-9]
        (_, new_map, bookkept), _ = sel[-10]
        _, motion = sel[1]
        mm = seen["mm"][-1][1]
        ins_map, ins_staged = (x[1] for x in seen["insert"][-2:])
        new = JxState(map=new_map, staged=staged, pose=pose, motion=motion,
                      last_matches=window, frame_number=state.frame_number,
                      status=state.status, ba=ba_new)
        return out, new, (
            bookkept.counter, bookkept.age, mm.match_idx, mm.d1, mm.d2,
            left.kp, left.valid, mm.matches_count, m_size,
            seen["pnp"][-1][1].inlier_count,
            ins_map.n_inserted + ins_staged.n_inserted, mm.used_wide_radius)

    return jax.jit(run)


def _capture(captor, state, left, right):
    """One frame through ``captor`` (:func:`_captor`): (lvt_tpu's (state,
    pose, metrics), the port's (new, TailInputs))."""
    out, new, (counter, age, idx, d1, d2, kp, *rest) = captor(state, left,
                                                             right)
    k = kp.shape[0]
    obs = np.asarray(kp)[np.clip(np.asarray(idx), 0, k - 1)]
    port = lambda x: convert.to_port(x, "cpu")  # noqa: E731
    inp = tail.TailInputs(*(port(x) for x in (counter, age, idx, d1, d2, obs,
                                              *rest)), None)
    return out, (port(new), inp)


def _features(left, right, cfg):
    """A frame pair's features as lvt_tpu's FrameFeatures, from the port's
    extraction (bit-equal to lvt_tpu's: tests/test_torch_system.py), which
    compiles nothing."""
    return [JxFeatures(*convert.to_numpy(f)) for f in
            extract.extract_features_stereo(torch.from_numpy(left),
                                            torch.from_numpy(right), cfg)]


@pytest.fixture(scope="module")
def tail_frames():
    """lvt_tpu's tail captured on five frames of test_torch_system's world
    (320 x 240, patch mode): frame 0 (init), frame 1 (tracking), frame 1
    from a LOST state, a blank frame (tracking lost), and frame 1 with local
    BA (a window of 2 poses every frame, one already in it: BA runs):
    {kind: (its input state, its outputs, the port's inputs, the
    config)}."""
    world = _world()
    cfg = _config(world)
    blank = [np.zeros((world.height, world.width), np.uint8)] * 2
    frames = [_features(l.astype(np.uint8), r.astype(np.uint8), cfg)
              for l, r, _ in world.stereo_sequence(2, speed=0.5)]
    ba_cfg = cfg.replace(local_ba_window=2, local_ba_every=1)
    cap = _captor(cfg)
    state = JxVOSystem(cfg).state
    out = {"init": (state, *_capture(cap, state, *frames[0]), cfg)}
    state = out["init"][1][0]
    lost = state._replace(status=np.int32(LOST))
    with_ba = state._replace(ba=JxVOSystem(ba_cfg).state.ba._replace(
        n=np.int32(1)))
    for kind, st, feats, c in (
            ("tracking", state, frames[1], cfg),
            ("lost", lost, frames[1], cfg),
            ("loses_track", state, _features(*blank, cfg), cfg),
            ("ba", with_ba, frames[1], ba_cfg)):
        out[kind] = (st, *_capture(cap if c is cfg else _captor(c), st,
                                   *feats), c)
    return out


@pytest.mark.parametrize("kind", ["init", "tracking", "loses_track", "lost",
                                  "ba"])
def test_plain_tail_matches_lvt_tpus(tail_frames, kind):
    state, (j_state, j_pose, j_metrics), (new, inp), cfg = tail_frames[kind]
    got_state, got_pose, got_metrics = tail.step_tail_plain(
        convert.to_port(state, "cpu"), new, inp,
        cfg.min_num_matches_for_tracking)
    want = convert.to_port(j_state, "cpu")
    for (path, g), (_, w) in zip(flatten_with_path(got_state),
                                 flatten_with_path(want)):
        assert g.dtype == w.dtype and torch.equal(g, w), path
    for g, w in zip(got_pose, convert.to_port(j_pose, "cpu")):
        assert torch.equal(g, w)
    for name in j_metrics._fields:
        g, w = _np(getattr(got_metrics, name)), np.asarray(
            getattr(j_metrics, name))
        if name in MEANS:
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert not bool(got_metrics.local_ba_ran)
    status = int(got_state.status)
    assert status == {"init": 2, "tracking": 2, "loses_track": 3, "lost": 3,
                      "ba": 2}[kind]
    if kind == "ba":   # lvt_tpu ran BA on this frame: the window moved
        assert int(got_state.ba.n) == 2


def _kernel_tree(x, threads=256):
    """csrc/tail.cu's order of a mean's sum in numpy float32: thread t
    holds x[t + j threads] of the padded vector, adds its registers' pairs
    (j, j + R/2), ..., then shared memory halves the live values down to
    32, then warp 0's __shfl_down_sync by 16, ..., 1."""
    n = len(x)
    p = 1
    while p < n:
        p *= 2
    v = np.zeros(p, np.float32)
    v[:n] = x
    r = max(1, p // threads)
    regs = v.reshape(r, -1) if p >= threads else v[None]
    while regs.shape[0] > 1:
        h = regs.shape[0] // 2
        regs = (regs[:h] + regs[h:]).astype(np.float32)
    red = regs[0]
    while len(red) > 32:
        h = len(red) // 2
        red = (red[:h] + red[h:]).astype(np.float32)
    while len(red) > 1:   # lane i takes lane i + h
        h = len(red) // 2
        red = (red[:h] + red[h:2 * h]).astype(np.float32)
    return red[0]


@pytest.mark.parametrize("n", [1, 31, 1024, 1536, 4096])
def test_ordered_sum_is_the_kernels_tree(n):
    rs = np.random.RandomState(n)
    x = (rs.randn(n) * 10 ** rs.uniform(-3, 6, n)).astype(np.float32)
    got = tail.ordered_sum(torch.from_numpy(x)).numpy()
    assert got.tobytes() == np.float32(_kernel_tree(x)).tobytes()
    # rows at once, and a strided view (a column of PnP's observations)
    two = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    assert torch.equal(tail.ordered_sum(two)[0], torch.from_numpy(got))
    col = torch.from_numpy(np.stack([x, x], 1))[:, 1]
    assert torch.equal(tail.ordered_sum(col), torch.from_numpy(got))


@pytest.mark.parametrize("s,kw", [(1, {}), (8, {"f": 4}),
                                  (3, {"m": 51, "n": 41, "k": 301})])
def test_step_tail_op_on_the_cpu_is_its_plain_version(s, kw):
    """The op's CPU kernel is the plain version stream by stream; the
    single-stream wrapper (the step's call) gives stream 0's bits; under
    ``torch.func.vmap`` the rule's one call gives each stream its own."""
    args = tail_problem(np.random.RandomState(s), s, "cpu", m=kw.get(
        "m", 256), n=kw.get("n", 128), k=kw.get("k", 300), f=kw.get("f", 0))
    got = tail.step_tail_op(*args, TAIL_MIN_MATCHES)
    want = [torch.stack(x) for x in zip(*(
        _tail_plain(_tail_stream(args, i)) for i in range(s)))]
    _assert_outputs_equal(got, [x[:, 0] for x in want], "step_tail")
    state, new = (from_leaves(tail._TEMPLATE, [x[0] for x in xs])
                  for xs in args[:2])
    inp = tail._inputs([x[0] for x in args[2]])
    res = tail.step_tail(state, new, inp, TAIL_MIN_MATCHES)
    _assert_outputs_equal([*leaves(res[0]), *res[1], *res[2]],
                          [x[0] for x in got], "step_tail wrapper")
    sizes = [len(xs) for xs in args]

    def one(*xs):
        it = iter(x[None] for x in xs)
        return tail.step_tail_op(*([next(it) for _ in range(n)]
                                   for n in sizes), TAIL_MIN_MATCHES)

    batched = torch.func.vmap(one)(*(x for xs in args for x in xs))
    _assert_outputs_equal([x[:, 0] for x in batched], got, "step_tail vmap")


def test_step_tail_op_opcheck():
    args = tail_problem(np.random.RandomState(2), 2, "cpu", m=40, n=20, k=30,
                        f=2)
    torch.library.opcheck(tail.step_tail_op, (*args, TAIL_MIN_MATCHES))


def test_tail_layout_is_the_state_and_metrics():
    """The op's leaf order is VOState's, and its metric dtypes
    StepMetrics'."""
    state = VOState.initial(8, 4, 2, device="cpu")
    assert tail.PATHS == [p for p, _ in flatten_with_path(state)]
    assert tail.METRIC_DTYPES == tuple(x.dtype for x in StepMetrics.zero())


def test_copy_leaves_reads_every_source_before_writing():
    """The runner's copy keeps copy_into's rule: two buffers swapped, each
    source cloned before anything is written (on the CPU the copy is
    copy_into; the sources it hands the kernel share no buffer's
    storage)."""
    a, b = torch.arange(5.0), -torch.arange(5.0)
    graphs.copy_leaves(Pose(a, b), Pose(b, a))
    assert torch.equal(a, -torch.arange(5.0))
    assert torch.equal(b, torch.arange(5.0))
    dsts = [a, b]
    srcs = graphs._unaliased(dsts, [b, a, torch.zeros(2)])
    held = {d.untyped_storage().data_ptr() for d in dsts}
    assert all(s.untyped_storage().data_ptr() not in held for s in srcs)
    assert torch.equal(srcs[0], b) and torch.equal(srcs[1], a)
