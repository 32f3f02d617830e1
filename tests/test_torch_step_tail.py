"""The step's tail (lvt_tpu_torch/core/tail.py: ``step_tail_plain``,
``step_tail``, ``step_tail_streams``, ``ordered_sum``) and the runner's
copy and frame end (core/graphs.py: ``copy_leaves``, ``Epilogue``) on the
CPU, where the tail is its plain version stream by stream and the copy is
``copy_into`` (the CUDA kernels of csrc/tail.cu are held against them in
tests/test_torch_cuda.py).

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
    (registers, shared memory, the warp's shuffles), the multi-stream
    tail and the tail under ``torch.func.vmap`` against the plain version
    per stream, and the copy: bit-equal.
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
from lvt_tpu_torch.tree import (flatten_with_path, from_leaves, leaves,
                                tree_map)
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


def _pairs(v, axis=-1):
    """The tree over ``axis`` in float32: halves added (i with i + h) down
    to one value."""
    v = np.moveaxis(v, axis, -1)
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = (v[..., :h] + v[..., h:]).astype(np.float32)
    return v[..., 0]


def _kernel_tree(x, cluster=8, threads=256, qmax=8):
    """csrc/tail.cu's order of a mean's sum in numpy float32: the padded
    vector's slots split by residue over min(cluster, P) blocks and their
    threads; thread t of block b sums its Q slots b + ge (t + te q) in
    batches of min(Q, qmax) (each the tree over its slots), the batches in
    bit-reversed order merged by a stack of partial sums; the block's
    threads by shared memory halves down to 32 and warp 0's shuffles (lane
    i + lane i + h); then the blocks' sums by the tree over ranks."""
    p = 1
    while p < len(x):
        p *= 2
    v = np.zeros(p, np.float32)
    v[:len(x)] = x
    ge = min(cluster, p)
    te = min(threads, p // ge)
    q = p // (ge * te)
    qb = min(q, qmax)
    batches = q // qb
    bits = batches.bit_length() - 1
    t = np.arange(te)[:, None]
    blocks = []
    for b in range(ge):
        stack = {}
        for pp in range(batches):
            r = int(format(pp, f"0{bits}b")[::-1], 2) if bits else 0
            c = _pairs(v[b + ge * (t + te * (r + batches * np.arange(qb)))])
            level = 0
            while (pp >> level) & 1:
                c = (stack[level] + c).astype(np.float32)
                level += 1
            stack[level] = c
        part = stack[bits]
        while len(part) > 32:       # shared memory
            h = len(part) // 2
            part = (part[:h] + part[h:]).astype(np.float32)
        while len(part) > 1:        # lane i takes lane i + h
            h = len(part) // 2
            part = (part[:h] + part[h:2 * h]).astype(np.float32)
        blocks.append(part[0])
    return _pairs(np.array(blocks, np.float32))


@pytest.mark.parametrize("n,cluster,qmax", [
    (1, 8, 8), (31, 8, 8), (1024, 8, 8), (1536, 8, 8), (4096, 8, 8),
    (8192, 8, 8), (16384, 8, 8), (16384, 1, 8), (16384, 2, 8),
    (4096, 4, 8), (1024, 8, 2), (16384, 8, 2), (16384, 8, 1),
    (3000, 2, 1)])
def test_ordered_sum_is_the_kernels_tree(n, cluster, qmax):
    """ordered_sum against the kernel's order (at qmax 8 as built; at
    qmax 1 and 2 the batches and stack a thread takes past 8 slots of M >
    16384, here at smaller M), at the kernel's 8 blocks a stream and, for
    the residue split itself, at 1, 2 and 4."""
    rs = np.random.RandomState(n + cluster)
    x = (rs.randn(n) * 10 ** rs.uniform(-3, 6, n)).astype(np.float32)
    got = tail.ordered_sum(torch.from_numpy(x)).numpy()
    assert got.tobytes() == np.float32(
        _kernel_tree(x, cluster, qmax=qmax)).tobytes()
    # rows at once, and a strided view (a column of PnP's observations)
    two = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    assert torch.equal(tail.ordered_sum(two)[0], torch.from_numpy(got))
    col = torch.from_numpy(np.stack([x, x], 1))[:, 1]
    assert torch.equal(tail.ordered_sum(col), torch.from_numpy(got))


@pytest.mark.parametrize("s,kw", [(1, {}), (8, {"f": 4}),
                                  (3, {"m": 51, "n": 41, "k": 301})])
def test_step_tail_streams_on_the_cpu_is_its_plain_version(s, kw):
    """On the CPU the multi-stream tail (``tail.step_tail_streams``) is
    the plain version stream by stream; the single-stream tail (the step's
    call) gives stream 0's bits, and under ``torch.func.vmap`` each stream
    its own."""
    args = tail_problem(np.random.RandomState(s), s, "cpu", m=kw.get(
        "m", 256), n=kw.get("n", 128), k=kw.get("k", 300), f=kw.get("f", 0))
    want = [torch.stack(x) for x in zip(*(
        _tail_plain(_tail_stream(args, i)) for i in range(s)))]
    want = [x[:, 0] for x in want]
    states, new = (from_leaves(tail._TEMPLATE, xs) for xs in args[:2])
    inp = tail.TailInputs(*args[2][:-1], None if args[2][-1].dim() == 2
                          else args[2][-1])
    res = tail.step_tail_streams(states, new, inp, TAIL_MIN_MATCHES)
    got = [*leaves(res[0]), *res[1], *res[2]]
    _assert_outputs_equal(got, want, "step_tail_streams")
    one = [[x[0] for x in xs] for xs in args]
    state, new = (from_leaves(tail._TEMPLATE, xs) for xs in one[:2])
    res = tail.step_tail(state, new, tail._inputs(one[2]), TAIL_MIN_MATCHES)
    _assert_outputs_equal([*leaves(res[0]), *res[1], *res[2]],
                          [x[0] for x in want], "step_tail")

    def stream(*xs):
        st, nw = (from_leaves(tail._TEMPLATE, list(xs[a:b])) for a, b in (
            (0, len(tail.PATHS)), (len(tail.PATHS), 2 * len(tail.PATHS))))
        r = tail.step_tail(st, nw, tail._inputs(list(xs[2 * len(
            tail.PATHS):])), TAIL_MIN_MATCHES)
        return [*leaves(r[0]), *r[1], *r[2]]

    flat = [x for xs in args[:2] for x in xs] + args[2]
    if args[2][-1].dim() == 2:    # no BA: the [S, 0] placeholder stays
        batched = torch.func.vmap(lambda *xs: stream(*xs, args[2][-1][0]))(
            *flat[:-1])
    else:
        batched = torch.func.vmap(stream)(*flat)
    _assert_outputs_equal(batched, want, "step_tail under vmap")


def test_overlapping_finds_sources_over_other_buffers():
    """``graphs.overlapping``: a source is flagged where it overlaps one of
    the buffers other than as the buffer it goes to (a view at another
    offset, a buffer swapped in, a slice across two), not where it is its
    own buffer, a new tensor, or empty; ``unaliased`` clones exactly the
    flagged ones."""
    store = torch.zeros(64)
    a, b = store[:16], store[16:48]
    dsts = [a, b, b]
    srcs = [a, a[4:], torch.zeros(32)]
    assert graphs.overlapping(dsts, srcs) == [False, True, False]
    assert graphs.overlapping([a, b], [b, store[10:20]]) == [True, True]
    assert graphs.overlapping([a, b], [store[48:], store[:0]]) == [False,
                                                                  False]
    assert graphs.overlapping([a, b], [a[:8], b]) == [True, False]
    out = graphs.unaliased(dsts, srcs)
    assert out[0] is a and out[2] is srcs[2]
    assert out[1] is not srcs[1] and torch.equal(out[1], srcs[1])


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
    srcs = graphs.unaliased(dsts, [b, a, torch.zeros(2)])
    held = {d.untyped_storage().data_ptr() for d in dsts}
    assert all(s.untyped_storage().data_ptr() not in held for s in srcs)
    assert torch.equal(srcs[0], b) and torch.equal(srcs[1], a)


def _aliased(new, buffers, alias):
    """``new`` with leaves that alias the runner's ``buffers``: the staged
    set as the buffers themselves ("same": the same address), or the map's
    counter and age and the map's and staged set's validity from each
    other's buffers ("other": other addresses)."""
    if alias == "same":
        return new._replace(staged=buffers.staged)
    if alias == "other":
        return new._replace(
            map=new.map._replace(counter=buffers.map.age,
                                 age=buffers.map.counter,
                                 valid=buffers.staged.valid),
            staged=new.staged._replace(valid=buffers.map.valid))
    return new


@pytest.mark.parametrize("reset", [False, True])
@pytest.mark.parametrize("alias", ["none", "same", "other"])
def test_the_plain_epilogue_is_the_plain_tail_then_copy_into(alias, reset):
    """The runner's end of a frame on the CPU (``Epilogue.finish``, where
    the tail did not end it) after the plain tail of 3 streams (lost,
    init, tracking): the state's buffers equal ``copy_into`` of the new
    state, also when its leaves alias the buffers at the same address or
    at others, after ``tail.reset_lost`` where the runner resets; row i of
    the chunk's rows holds the tail's pose and metrics; frame i + 1 is in
    the input buffer and the counter advanced, frame after frame."""
    args = tail_problem(np.random.RandomState(11), 3, "cpu", m=40, n=40,
                        k=30, f=2)
    buffers = from_leaves(tail._TEMPLATE, [x.clone() for x in args[0]])
    fresh = (from_leaves(tail._TEMPLATE, [x[1].clone() for x in args[1]])
             if reset else None)
    chunk = torch.arange(3 * 6, dtype=torch.float32).reshape(3, 6)
    epilogue = graphs.Epilogue(buffers, [torch.zeros(6)], reset=fresh)
    rows = epilogue.start([chunk])
    assert torch.equal(epilogue.inputs[0], chunk[0])
    for i in range(3):
        before = tree_map(torch.clone, buffers)
        out = tail._plain_streams(leaves(before), args[1], args[2],
                                  TAIL_MIN_MATCHES)
        state, pose, metrics = tail._unpack(before, out)
        new = _aliased(state, buffers, alias)
        want = tree_map(torch.clone, before)
        graphs.copy_into(want, tree_map(torch.clone, new))
        if reset:
            want = tail.reset_lost(want, fresh)
        epilogue.finish(new, pose, metrics)
        _assert_outputs_equal(leaves(buffers), leaves(want), "state")
        _assert_outputs_equal([x[i] for x in graphs._rows_of(rows)],
                              [*pose, *metrics], "rows")
        assert int(epilogue.counter) == i + 1
        assert torch.equal(epilogue.inputs[0], chunk[min(i + 1, 2)])
