"""The step's tail as one custom op over a leading stream axis S,
``lvt_tpu_torch::step_tail`` (the profiler range ``step_tail``; port of
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

The op is built as core/track.py's ops are:

* CUDA: one launch of ``csrc/tail.cu``'s ``step_tail_kernel`` for all S
  streams, bit-equal to the plain version; one stream outside vmap (the
  single-stream step) launches it from :func:`step_tail` directly, without
  the op's dispatch and its stream axis's views, which cost an eager step
  as much host time as the launch;
* CPU: the plain version (:func:`step_tail_plain`, the torch code the step
  ran before) stream by stream; on the card a reference for the tests and
  chip_smoke.py, never the main path;
* fake tensors: the output shapes; ``torch.func.vmap``: a rule that folds
  vmap's axis into the stream axis (one launch for every stream of the
  multi-stream step).

With a ``group`` (the sharded-map modes) :func:`step_tail` runs the plain
version with its collectives: a collective cannot run inside a kernel.
The runner's copy of the new state into its static buffers is one launch
of ``copy_leaves_kernel`` of the same source (core/graphs.py::copy_leaves).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from lvt_tpu_torch import kernels
from lvt_tpu_torch.core.motion import MotionState
from lvt_tpu_torch.core.state import (LOST, NOT_INITIALIZED, TRACKING,
                                      ObsWindow, PointStore, StepMetrics,
                                      VOState)
from lvt_tpu_torch.core.track import select
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.ops.collectives import psum_if
from lvt_tpu_torch.tree import flatten_with_path, from_leaves, leaves


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
# StepMetrics' leaves' dtypes, in field order
METRIC_DTYPES = ((torch.int32,) * 4 + (torch.float32,) * 5
                 + (torch.int32,) * 2 + (torch.bool, torch.int32, torch.bool))


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
    """One stream's TailInputs from the op's list (``ba_ran`` [0]: None)."""
    *rest, ba = values
    return TailInputs(*rest, None if ba.dim() == 1 else ba)


def _outputs(state, pose, metrics) -> list:
    return [*leaves(state), *pose, *metrics]


def _step_tail_cpu(state, new, inputs, min_matches):
    outs = []
    for i in range(state[0].shape[0]):
        st, nw = (from_leaves(_TEMPLATE, [x[i] for x in xs])
                  for xs in (state, new))
        outs.append(_outputs(*step_tail_plain(
            st, nw, _inputs([x[i] for x in inputs]), min_matches)))
    return [torch.stack(o) for o in zip(*outs)]


@functools.lru_cache(maxsize=None)
def tail_shape() -> tuple[int, int]:
    """csrc/tail.cu's limits: leaves a launch, the largest M of
    step_tail."""
    out = (ctypes.c_int * 2)()
    kernels.check(kernels.lib().lvt_tail_shape(out), "tail (shape)")
    return tuple(out)


def _batched(t: torch.Tensor) -> bool:
    """Whether ``t`` is a tensor of ``torch.func.vmap`` (then the op's
    batching rule folds the streams)."""
    return torch._C._functorch.is_batchedtensor(t)


def _ptrs(*ts) -> ctypes.Array:
    return (ctypes.c_void_p * len(ts))(*(
        None if t is None else t.data_ptr() for t in ts))


def _launch(state: list, new: list, inp: TailInputs, min_matches: int,
            lead: tuple) -> list:
    """One launch of ``csrc/tail.cu``'s ``step_tail_kernel``: the op's CUDA
    kernel (``lead`` (S,): every tensor [S, ...]) and :func:`step_tail`'s
    on one stream's tensors (``lead`` (): no stream axis, no views in or
    out). ``inp.ba_ran`` None: no local BA. Returns the new state's
    leaves, the pose (t, q) and StepMetrics' 14 leaves."""
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
    if m > tail_shape()[1]:
        raise ValueError(f"step_tail: M={m} map slots exceed the kernel's "
                         f"{tail_shape()[1]}")
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
    outs = ([torch.empty_like(x) for x in state]
            + [torch.empty_like(t), torch.empty_like(q)]
            + [t.new_empty(lead, dtype=d) for d in METRIC_DTYPES])
    fallback = list(state)
    fallback[_IDX[".map.counter"]] = inp.bookkept_counter
    fallback[_IDX[".map.age"]] = inp.bookkept_age
    rows = [(new[i], fallback[i], state[i], outs[i], KINDS[i])
            for i in KINDS]
    rows += [(new[i], state[i], state[i], outs[len(PATHS) + j], TRACK)
             for j, i in enumerate((_IDX[".pose.t"], _IDX[".pose.q"]))]
    ptrs = _ptrs(*(x for r in rows for x in r[:4]))
    nbytes = (ctypes.c_longlong * len(rows))(*(
        r[3].numel() // max(s, 1) * r[3].element_size() for r in rows))
    kinds = (ctypes.c_int * len(rows))(*(r[4] for r in rows))
    scalars = _ptrs(state[STATUS], state[FRAME], inp.matches_count,
                    state[_IDX[".map.valid"]], state[_IDX[".staged.valid"]],
                    inp.bookkept_age, inp.match_idx, inp.d1, inp.d2, inp.obs,
                    inp.feat_valid, inp.map_size, inp.inlier_count,
                    inp.n_inserted, inp.used_wide_radius, inp.ba_ran)
    written = _ptrs(outs[FRAME], outs[STATUS], *outs[len(PATHS) + 2:])
    with torch.cuda.device(dev):
        err = kernels.lib().lvt_step_tail(
            ptrs, nbytes, kinds, len(rows), scalars, written, s, m, n, k,
            int(min_matches), kernels.stream_ptr(state[0]))
    kernels.check(err, "step_tail")
    step_tail.launches += 1
    return outs


@torch.library.custom_op("lvt_tpu_torch::step_tail", mutates_args=(),
                         device_types="cuda")
def step_tail_op(state: list[torch.Tensor], new: list[torch.Tensor],
                 inputs: list[torch.Tensor],
                 min_matches: int) -> list[torch.Tensor]:
    """S streams: the state's leaves [S, ...] (PATHS' order), the tracked
    values' (the same shapes; frame_number and status not read), the
    TailInputs [S, ...] (``ba_ran`` [S, 0]: no local BA), and
    min_num_matches_for_tracking -> the new state's leaves, the pose (t
    [S, 3], q [S, 4]) and StepMetrics' 14 leaves [S].

    CUDA: one launch of ``csrc/tail.cu``'s ``step_tail_kernel``, grid
    (the five means' blocks, the scalars' block, the leaves' copy blocks;
    S)."""
    s = state[0].shape[0]
    *rest, ba = inputs
    if ba.dim() == 2:   # no local BA
        kernels.require(ba, "ba_ran", torch.bool, (s, 0), state[0].device)
        ba = None
    return _launch(state, new, TailInputs(*rest, ba), min_matches, (s,))


@step_tail_op.register_fake
def _step_tail_fake(state, new, inputs, min_matches):
    s = state[0].shape[0]
    t, q = state[_IDX[".pose.t"]], state[_IDX[".pose.q"]]
    return ([torch.empty_like(x) for x in state]
            + [torch.empty_like(t), torch.empty_like(q)]
            + [t.new_empty((s,), dtype=d) for d in METRIC_DTYPES])


def _step_tail_vmap(info, in_dims, state, new, inputs, min_matches):
    """Batching rule: vmap's axis B folded into the stream axis of every
    tensor, one launch, the outputs unfolded to [B, S, ...]."""
    b = info.batch_size
    lists = (state, new, inputs)
    flat = iter(kernels.fold_streams(
        info, [d for dims in in_dims[:3] for d in dims],
        [x for xs in lists for x in xs]))
    outs = step_tail_op(*([next(flat) for _ in xs] for xs in lists),
                        min_matches)
    return ([x.view(b, x.shape[0] // b, *x.shape[1:]) for x in outs],
            [0] * len(outs))


step_tail_op.register_kernel("cpu")(_step_tail_cpu)
step_tail_op.register_vmap(_step_tail_vmap)


def step_tail(state: VOState, new: VOState, inp: TailInputs,
              min_matches: int, group=None):
    """:func:`step_tail_plain` for one stream: CPU tensors take the plain
    version, CUDA tensors the kernel, and under ``torch.func.vmap`` one
    launch serves every stream. With a ``group``, the plain version."""
    if group is not None:
        return step_tail_plain(state, new, inp, min_matches, group)
    dev = state.status.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"step_tail: expected a CUDA tensor, got {dev}")
    st, nw = leaves(state), leaves(new)
    if dev.type == "cuda" and not any(map(_batched, (*st, *nw, *inp[:-1]))):
        # one stream outside vmap: the launch itself, without the op's
        # stream axis ([None] in, [0] out)
        outs = _launch(st, nw, inp, min_matches, ())
    else:
        ba = inp.feat_valid[:0] if inp.ba_ran is None else inp.ba_ran
        outs = [x[0] for x in step_tail_op(
            [x[None] for x in st], [x[None] for x in nw],
            [x[None] for x in (*inp[:-1], ba)], int(min_matches))]
    n = len(PATHS)
    return (from_leaves(state, outs[:n]), Pose(*outs[n:n + 2]),
            StepMetrics(*outs[n + 2:]))


step_tail.launches = 0
