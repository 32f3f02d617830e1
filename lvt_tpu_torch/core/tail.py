"""The step's tail as one kernel over a leading stream axis S (the
profiler range ``step_tail``; port of
lvt_tpu/core/step.py:531-570 and :597-612, XLA ops that XLA fuses on the
TPU; not a TPU kernel): every leaf of the new state as

    ``is_lost ? state : (is_tracking ? new : fallback)``

(the fallback is the bookkept map for the map's counter and age, the
state's leaf elsewhere; the BA window takes ``new`` on tracking frames that
are not the init frame, the motion state whenever the frame is not lost),
the frame counter and the status, the returned pose, and the frame's
``StepMetrics`` with their five means over the map's matched slots.

Each mean is :func:`ordered_sum` of the masked [M] vector over
``max(matches_count, 1)``: a sum in one stated order, so that the kernel,
the CPU and the sharded step (``psum_if`` of each rank's sum) give one
result. lvt_tpu's ``jnp.sum`` takes XLA's order, so the means agree with
lvt_tpu's to float32 rounding, not bit for bit.

On the card the tail is one launch of ``csrc/tail.cu``'s
``step_tail_kernel`` for all S streams (a thread-block cluster a stream),
bit-equal to the plain version: :func:`step_tail` on one stream's tensors,
:func:`step_tail_streams` on S streams after the vmapped body
(parallel/multistream.py). On the CPU both run the plain version
(:func:`step_tail_plain`, the torch code the step ran before); on the card
that is a reference for the tests and chip_smoke.py, never the main path.

Inside a runner's frame (core/graphs.py: the runner's ``Epilogue`` is
active and the tail's state is the runner's) the same launch also ends the
frame on the device: it writes the new state into the runner's buffers
(the state it reads), resets a stream it lost to the runner's fresh state
but its pose where the runner resets (:func:`reset_lost`), writes the pose
and the metrics into row i of the chunk's outputs and frame i + 1's inputs
into the runner's input buffers, and advances i, a counter in the runner's
table; :func:`step_tail` then returns the state and no pose or metrics.
Elsewhere (the CPU, a group) the runner ends the frame itself
(``Epilogue.finish``).

With a ``group`` (the sharded-map modes) :func:`step_tail` runs the plain
version with its collectives: a collective cannot run inside a kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from lvt_tpu_torch import kernels
from lvt_tpu_torch.core import graphs
from lvt_tpu_torch.core.motion import MotionState
from lvt_tpu_torch.core.state import (LOST, NOT_INITIALIZED, TRACKING,
                                      ObsWindow, PointStore, StepMetrics,
                                      VOState)
from lvt_tpu_torch.core.track import select
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.ops.collectives import psum_if
from lvt_tpu_torch.tree import (flatten_with_path, from_leaves, leaves,
                                tree_map)


class TailInputs(NamedTuple):
    """What the tail reads besides the state and the tracked values (one
    stream's shapes)."""
    bookkept_counter: torch.Tensor  # [M] int32 the map after bookkeeping
    bookkept_age: torch.Tensor      # [M] int32
    match_idx: torch.Tensor         # [M] int64 the map match's
    d1: torch.Tensor                # [M] f32 its best distances
    d2: torch.Tensor                # [M] f32 its second distances
    obs: torch.Tensor               # [M, 2] f32 PnP's observations
    feat_valid: torch.Tensor        # [K] bool the left features'
    matches_count: torch.Tensor     # [] int64
    map_size: torch.Tensor          # [] int64 the new map's valid points
    inlier_count: torch.Tensor      # [] int64 PnP's
    n_inserted: torch.Tensor        # [] int64 points inserted
    used_wide_radius: torch.Tensor  # [] bool
    ba_ran: torch.Tensor | None     # [] bool whether local BA ran; None: off


# a leaf's rule (csrc/tail.cu Kind): new on tracking, new on tracking and
# not init, new whenever not lost
TRACK, TRACK_NOT_INIT, ALWAYS = 0, 1, 2
_FIELD_KIND = {"map": TRACK, "staged": TRACK, "pose": TRACK,
               "motion": ALWAYS, "last_matches": TRACK,
               "ba": TRACK_NOT_INIT}
# VOState's structure (placeholder leaves) and its leaves' paths in tree
# order
_TEMPLATE = VOState(
    PointStore(*[None] * 5), PointStore(*[None] * 5), Pose(None, None),
    MotionState(*[None] * 4), None, None, None, ObsWindow(*[None] * 7))
PATHS = [p for p, _ in flatten_with_path(_TEMPLATE)]
# the leaves the scalar block writes (csrc/tail.cu), and the others' rules
FRAME, STATUS = PATHS.index(".frame_number"), PATHS.index(".status")
KINDS = {i: _FIELD_KIND[p.split(".")[1]] for i, p in enumerate(PATHS)
         if i not in (FRAME, STATUS)}
_IDX = {p: PATHS.index(p) for p in (".map.counter", ".map.age", ".map.valid",
                                    ".staged.valid", ".pose.t", ".pose.q")}
# StepMetrics' leaves' dtypes, in field order, and their bytes
METRIC_DTYPES = ((torch.int32,) * 4 + (torch.float32,) * 5
                 + (torch.int32,) * 2 + (torch.bool, torch.int32, torch.bool))
METRIC_BYTES = tuple(torch.empty((), dtype=d).element_size()
                     for d in METRIC_DTYPES)


def reset_lost(states: VOState, fresh: VOState) -> VOState:
    """Every LOST stream of ``states`` (leaves [S, ...]) takes ``fresh``
    (one stream's initial state) in its slice, keeping its pose; the
    others are untouched (lvt_tpu/parallel/multistream.py's
    ``_reset_lost``; the kernel's reset, csrc/tail.cu)."""
    lost = states.status == LOST

    def sel(new, old):
        return torch.where(lost.reshape(lost.shape + (1,) * (old.ndim - 1)),
                           new, old)

    return tree_map(sel, fresh, states)._replace(pose=states.pose)


def row_templates(state: VOState) -> tuple:
    """One frame's (pose, metrics) of a step on ``state`` (one stream, or
    leaves [S, ...]): tensors of their shapes and dtypes, for a runner's
    rows."""
    lead = tuple(state.status.shape)
    return (tree_map(torch.empty_like, state.pose),
            StepMetrics(*(torch.empty(lead, dtype=d,
                                      device=state.status.device)
                          for d in METRIC_DTYPES)))


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis in one stated order: padded with 0.0 to a
    power of two P, then ``x[..., :h] + x[..., h:]`` for h = P/2, ..., 1,
    one float32 rounding each (csrc/tail.cu's tree)."""
    p = 1
    while p < x.shape[-1]:
        p *= 2
    x = torch.nn.functional.pad(x, (0, p - x.shape[-1]))
    while p > 1:
        p //= 2
        x = x[..., :p] + x[..., p:]
    return x[..., 0]


def step_tail_plain(state: VOState, new: VOState, inp: TailInputs,
                    min_matches: int, group=None):
    """The tail of one stream's step: the state's selects on the frame's
    outcome, the returned pose and the metrics. ``new``: the tracked
    values (its ``frame_number`` and ``status`` are not read); ``group``:
    the stores are this rank's blocks (core/step.py). Returns (state',
    pose, metrics)."""
    is_init = state.status == NOT_INITIALIZED
    is_lost = state.status == LOST
    is_tracking = (inp.matches_count >= min_matches) | is_init
    bookkept = state.map._replace(counter=inp.bookkept_counter,
                                  age=inp.bookkept_age)
    tracked = VOState(
        map=select(is_tracking, new.map, bookkept),
        staged=select(is_tracking, new.staged, state.staged),
        pose=select(is_tracking, new.pose, state.pose),
        motion=new.motion,
        last_matches=torch.where(is_tracking, new.last_matches,
                                 state.last_matches),
        frame_number=state.frame_number + 1,
        status=torch.where(is_tracking, TRACKING, LOST).to(torch.int32),
        ba=select(is_tracking & ~is_init, new.ba, state.ba),
    )
    # the five means' sums as one [5, M] ordered_sum (each row's bits are
    # its own ordered_sum's), each summed over the group on its own
    n_matched = torch.clamp(inp.matches_count, min=1)
    sums = ordered_sum(torch.where(inp.match_idx >= 0, torch.stack([
        inp.bookkept_age.float(), inp.d1, inp.d2, inp.obs[:, 0],
        inp.obs[:, 1]]), 0.0))
    means = [psum_if(x, group) / n_matched for x in sums.unbind(0)]
    ba_ran = torch.zeros_like(is_init) if inp.ba_ran is None else inp.ba_ran
    metrics = StepMetrics(
        map_points_count=torch.where(
            is_init, inp.map_size,
            psum_if(state.map.size(), group)).to(torch.int32),
        staged_points_count=psum_if(state.staged.size(),
                                    group).to(torch.int32),
        image_keypoints=inp.feat_valid.sum().to(torch.int32),
        tracked_map_points=inp.matches_count.to(torch.int32),
        mean_age=means[0],
        mean_closest_descriptor_distance=means[1],
        mean_second_descriptor_distance=means[2],
        mean_feature_x=means[3],
        mean_feature_y=means[4],
        inlier_count=inp.inlier_count.to(torch.int32),
        triangulated_points=torch.where(is_tracking, inp.n_inserted,
                                        0).to(torch.int32),
        used_wide_radius=inp.used_wide_radius & ~is_init,
        status=tracked.status,
        local_ba_ran=ba_ran & is_tracking & ~is_init,
    )
    lost_metrics = StepMetrics.zero(state.status.device)._replace(
        map_points_count=psum_if(state.map.size(), group).to(torch.int32),
        status=torch.full((), LOST, dtype=torch.int32,
                          device=state.status.device))
    lost_state = state._replace(frame_number=state.frame_number + 1)
    return (select(is_lost, lost_state, tracked),
            select(is_lost, state.pose, tracked.pose),
            select(is_lost, lost_metrics, metrics))


def _inputs(values) -> TailInputs:
    """One stream's TailInputs from a list whose ``ba_ran`` is [0] where
    there is no local BA (None)."""
    *rest, ba = values
    return TailInputs(*rest, None if ba.dim() == 1 else ba)


def _outputs(state, pose, metrics) -> list:
    return [*leaves(state), *pose, *metrics]


def _plain_streams(state: list, new: list, inputs: list,
                   min_matches: int) -> list:
    """The plain version of S streams in list form: the state's and the
    tracked values' leaves [S, ...] (PATHS' order), the TailInputs [S, ...]
    (``ba_ran`` [S, 0]: no local BA) -> the new state's leaves, the pose
    (t, q) and StepMetrics' 14 leaves, [S, ...] each; stream by stream on
    any device (the CPU's multi-stream tail; on the card the kernel's
    reference)."""
    outs = []
    for i in range(state[0].shape[0]):
        st, nw = (from_leaves(_TEMPLATE, [x[i] for x in xs])
                  for xs in (state, new))
        outs.append(_outputs(*step_tail_plain(
            st, nw, _inputs([x[i] for x in inputs]), min_matches)))
    return [torch.stack(o) for o in zip(*outs)]


@functools.lru_cache(maxsize=None)
def tail_shape() -> tuple[int, int, int, int, int]:
    """csrc/tail.cu's limits: leaves a launch, a chunk table's bytes, rows,
    a frame's inputs, and the units of a stream's state that step_tail
    holds over its barrier."""
    out = (ctypes.c_int * 5)()
    kernels.check(kernels.lib().lvt_tail_shape(out), "tail (shape)")
    return tuple(out)


def _ptrs(*ts) -> ctypes.Array:
    return (ctypes.c_void_p * len(ts))(*(
        None if t is None else t.data_ptr() for t in ts))


def _units(leaves5, s: int) -> int:
    """A stream's units of the kernel's table (csrc/tail.cu make_table):
    each leaf's bytes a stream in the widest of 16, 8, 4 and 1 that divides
    them and its five addresses (``leaves5``: (bytes, tensors) a leaf)."""
    units = 0
    for nbytes, ts in leaves5:
        bits = nbytes
        for t in ts:
            bits |= 0 if t is None else t.data_ptr()
        units += nbytes // next(u for u in (16, 8, 4, 1) if bits % u == 0)
    return units


def _launch(state: list, new: list, inp: TailInputs, min_matches: int,
            lead: tuple, epilogue=None):
    """One launch of ``csrc/tail.cu``'s ``step_tail_kernel`` on S streams'
    tensors (``lead`` (S,): every tensor [S, ...]) or on one stream's
    (``lead`` (): no stream axis). ``inp.ba_ran`` None: no local BA.
    Without an ``epilogue`` returns the new state's leaves, the pose (t, q)
    and StepMetrics' 14 leaves, new tensors. With the runner's
    (core/graphs.py::Epilogue, whose state is ``state``) the launch ends
    the frame (module docstring) and returns None. Nothing is cloned: a
    source may be the buffer it goes to, and may overlap another buffer
    only where the kernel holds every unit of a stream's state over its
    barrier (``tail_shape()[4]`` units); elsewhere that is refused."""
    s = lead[0] if lead else 1
    dev = state[0].device
    if len(state) != len(PATHS) or len(new) != len(PATHS):
        raise ValueError(f"step_tail: {len(state)} and {len(new)} state "
                         f"leaves, not {len(PATHS)}")
    for i, (x, y) in enumerate(zip(state, new)):
        kernels.require(x, f"state{PATHS[i]}", x.dtype,
                        (*lead, *x.shape[len(lead):]), dev)
        kernels.require(y, f"new{PATHS[i]}", x.dtype, x.shape, dev)
    m, n = state[_IDX[".map.valid"]].shape[-1], \
        state[_IDX[".staged.valid"]].shape[-1]
    k = inp.feat_valid.shape[-1]
    i64, f32 = torch.int64, torch.float32
    for x, name, dtype, shape in (
            (inp.bookkept_counter, "bookkept_counter", torch.int32, (m,)),
            (inp.bookkept_age, "bookkept_age", torch.int32, (m,)),
            (inp.match_idx, "match_idx", i64, (m,)),
            (inp.d1, "d1", f32, (m,)), (inp.d2, "d2", f32, (m,)),
            (inp.obs, "obs", f32, (m, 2)),
            (inp.feat_valid, "feat_valid", torch.bool, (k,)),
            (inp.matches_count, "matches_count", i64, ()),
            (inp.map_size, "map_size", i64, ()),
            (inp.inlier_count, "inlier_count", i64, ()),
            (inp.n_inserted, "n_inserted", i64, ()),
            (inp.used_wide_radius, "used_wide_radius", torch.bool, ()),
            (inp.ba_ran, "ba_ran", torch.bool, ())):
        if x is not None:
            kernels.require(x, name, dtype, (*lead, *shape), dev)
    t, q = state[_IDX[".pose.t"]], state[_IDX[".pose.q"]]
    fallback = list(state)
    fallback[_IDX[".map.counter"]] = inp.bookkept_counter
    fallback[_IDX[".map.age"]] = inp.bookkept_age
    order = list(KINDS)
    nbytes = [state[i].numel() // s * state[i].element_size() for i in order]
    if epilogue is None:
        outs = ([torch.empty_like(x) for x in state]
                + [torch.empty_like(t), torch.empty_like(q)]
                + [t.new_empty(lead, dtype=d) for d in METRIC_DTYPES])
        dst, rows, fresh, chunk = outs[:len(PATHS)], outs[len(PATHS):], \
            None, None
        inputs = ()
    else:
        outs, rows = None, None
        dst = leaves(epilogue.state)
        fresh = None if epilogue.reset is None else leaves(epilogue.reset)
        chunk = epilogue.table
        inputs = epilogue.inputs if chunk is not None else ()
        srcs = [y for i in order for y in (new[i], fallback[i])]
        bufs = [dst[i] for i in order for _ in range(2)]
        if any(graphs.overlapping(bufs, srcs)) and _units(
                ((b, (new[i], fallback[i], state[i],
                      None if fresh is None else fresh[i], dst[i]))
                 for b, i in zip(nbytes, order)), s) > tail_shape()[4]:
            raise ValueError(
                "step_tail: a source overlaps another of the runner's "
                "buffers, and a stream's state exceeds the "
                f"{tail_shape()[4]} units the kernel holds over its barrier")
    pose_row = {_IDX[".pose.t"]: 0, _IDX[".pose.q"]: 1}
    ptrs = _ptrs(*(x for i in order for x in (
        new[i], fallback[i], state[i], None if fresh is None else fresh[i],
        dst[i])))
    kinds = (ctypes.c_int * len(order))(*(KINDS[i] for i in order))
    row_of = (ctypes.c_int * len(order))(*(pose_row.get(i, -1)
                                           for i in order))
    reset = (None, None) if fresh is None else (fresh[FRAME], fresh[STATUS])
    scalars = _ptrs(state[STATUS], state[FRAME], inp.matches_count,
                    state[_IDX[".map.valid"]], state[_IDX[".staged.valid"]],
                    inp.bookkept_age, inp.match_idx, inp.d1, inp.d2, inp.obs,
                    inp.feat_valid, inp.map_size, inp.inlier_count,
                    inp.n_inserted, inp.used_wide_radius, inp.ba_ran, *reset)
    written = _ptrs(dst[FRAME], dst[STATUS])
    row_bytes = (ctypes.c_longlong * 16)(
        t.numel() // s * t.element_size(), q.numel() // s * q.element_size(),
        *METRIC_BYTES)
    in_dst = _ptrs(*inputs) if inputs else None
    in_bytes = (ctypes.c_longlong * max(len(inputs), 1))(*(
        x.numel() * x.element_size() for x in inputs))
    with torch.cuda.device(dev):
        err = kernels.lib().lvt_step_tail(
            ptrs, (ctypes.c_longlong * len(order))(*nbytes), kinds, row_of,
            len(order), scalars, written,
            None if chunk is None else chunk.data_ptr(),
            None if rows is None else _ptrs(*rows), row_bytes, in_dst,
            in_bytes, len(inputs), s, m, n, k, int(min_matches),
            kernels.stream_ptr(state[0]))
    kernels.check(err, "step_tail")
    step_tail.launches += 1
    if epilogue is not None:
        epilogue.fused = True
    return outs


def _unpack(state, outs) -> tuple:
    n = len(PATHS)
    return (from_leaves(state, outs[:n]), Pose(*outs[n:n + 2]),
            StepMetrics(*outs[n + 2:]))


def step_tail(state: VOState, new: VOState, inp: TailInputs,
              min_matches: int, group=None):
    """:func:`step_tail_plain` for one stream: CUDA tensors take the
    kernel (one launch), CPU tensors and a ``group`` the plain version.
    Inside the frame of the runner whose state is ``state``, the kernel
    ends the frame (module docstring) and this returns (state, None,
    None)."""
    if group is not None or state.status.device.type != "cuda":
        return step_tail_plain(state, new, inp, min_matches, group)
    epilogue = graphs.active_epilogue(state)
    outs = _launch(leaves(state), leaves(new), inp, min_matches, (),
                   epilogue)
    return (state, None, None) if epilogue is not None else _unpack(state,
                                                                     outs)


def step_tail_streams(states: VOState, new: VOState, inp: TailInputs,
                      min_matches: int):
    """The tail of S streams (every leaf and input with a leading [S]; the
    vmapped body's outputs): one launch of the kernel on the card, the
    plain version stream by stream on the CPU. Inside the frame of the
    runner whose state is ``states``, the kernel ends the frame and this
    returns (states, None, None)."""
    s = states.status.shape[0]
    st = leaves(states)
    nw = [x.contiguous() for x in leaves(new)]
    inp = TailInputs(*(None if x is None else x.contiguous() for x in inp))
    if states.status.device.type != "cuda":
        ba = (inp.feat_valid.new_zeros((s, 0)) if inp.ba_ran is None
              else inp.ba_ran)
        return _unpack(states, _plain_streams(st, nw, [*inp[:-1], ba],
                                              min_matches))
    epilogue = graphs.active_epilogue(states)
    outs = _launch(st, nw, inp, min_matches, (s,), epilogue)
    return (states, None, None) if epilogue is not None else _unpack(states,
                                                                     outs)


step_tail.launches = 0
