"""The tracking branch's per-point work around kernel T, as four custom ops
over a leading stream axis S (port of the parts of lvt_tpu's jitted step
that XLA fuses on the TPU; none of them is a TPU kernel):

* ``lvt_tpu_torch::predict_project`` — the constant-velocity motion model
  (core/motion.py), the init frame's identity pose, and the projection
  and visibility of the map at the predicted pose (the query side of the
  map match; lvt_tpu core/motion.py:36, ops/matching.py:83-100);
* ``lvt_tpu_torch::upkeep_pre`` — the map's match bookkeeping and the cull
  of untracked points with the un-mark of their features (core/map.py:71,
  :85), the init frame's identity pose after PnP, and the projection and
  visibility of the staged points at it (the query side of the staged
  re-match; lvt_tpu core/step.py:171-190);
* ``lvt_tpu_torch::staged_promote`` — the staged re-match's acceptance,
  one-to-one resolution and claims, the counters, and the insertion of
  the promoted points into the map (core/step.py:190-231, core/map.py:28);
* ``lvt_tpu_torch::triangulate_insert`` — the row match's acceptance and
  resolution, stereo triangulation (or RGB-D back-projection), the
  triangulation policy, and the insertion of the new points into the map
  or the staged set (ops/triangulate.py:40-160, core/step.py:111-155);
* ``lvt_tpu_torch::ba_observe`` — with local BA on, the BA row match's
  acceptance and resolution, each map slot's right-camera observation,
  and the observation window's slide by this frame with its schedule
  (core/step.py:486-512, :232-267).

Each op is built as kernel T's (ops/top2.py):

* CUDA: one launch of its hand-written kernel of ``csrc/track.cu`` for
  all S streams, every float operation in the plain version's order and
  rounding, so the kernel gives the plain version's bits (``staged_promote``
  and ``triangulate_insert``: a thread-block cluster per stream, of
  :func:`cluster_size` blocks);
* CPU: the plain version (``*_plain``, the torch ops the step ran before)
  stream by stream; on the card the plain versions are a reference for the
  tests and chip_smoke.py, never the main path;
* fake tensors: the output shapes; ``torch.func.vmap``: a rule that folds
  vmap's axis into the stream axis, so the vmapped multi-stream step
  launches each op once for all streams.

The step (core/step.py) calls the single-stream wrappers below. With a
``group`` (the sharded-map modes: the stores are this rank's blocks)
``predict_project`` and ``ba_observe``, which reduce nothing over the
points, launch their kernels on the rank's block, and ``upkeep_pre``
launches its kernel and then runs its plain version's two collectives on
the kernel's outputs (the un-marks' OR, the map size's sum), which come
after all its per-point work; that gives the plain group version's bits.
``staged_promote``, ``triangulate_insert`` and the map match's
``map_accept`` reduce over the ranks in the middle of their work, so
under a group they run their plain versions with the collectives between
the torch ops.
"""

from __future__ import annotations

import ctypes
import functools
import sys
from typing import NamedTuple

import torch

from lvt_tpu_torch import kernels
from lvt_tpu_torch.config import MATCHES_WINDOW_INIT
from lvt_tpu_torch.core import map as map_ops
from lvt_tpu_torch.core.motion import MotionState, predict_next_pose
from lvt_tpu_torch.core.state import ObsWindow, PointStore
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.ops import hamming, matching, top2, triangulate
from lvt_tpu_torch.ops.collectives import (axis_index, axis_size, por_if,
                                           psum_if)
from lvt_tpu_torch.tree import tree_map

# the camera's projection and bounds, in the kernels' order
CAM_KEYS = ("fx", "fy", "cx", "cy", "near", "far", "min_x", "max_x", "min_y",
            "max_y")
# the ops, in the step's order
OPS = ("predict_project", "upkeep_pre", "staged_promote",
       "triangulate_insert", "ba_observe")
# feature slots the kernels hold per stream in shared memory (kernel T's
# bound, ops/top2.py)
MAX_K = 2048
# blocks per stream of the cluster kernels (staged_promote,
# triangulate_insert), the wrapper's choices in order (cluster_size)
CLUSTERS = (8, 4, 2, 1)
_CLUSTER_OPS = ("staged_promote", "triangulate_insert")
# the ops that launch their kernels under a group too (the sharded step)
GROUP_OPS = ("predict_project", "upkeep_pre", "ba_observe")


def select(pred, a, b):
    """Leaf-wise select of two containers on a scalar predicate."""
    return tree_map(lambda x, y: torch.where(pred, x, y), a, b)


def shard_partition_mask(insert_mask, group):
    """Partition insertion candidates, the same on every rank, across the
    group's ranks so each point lands in exactly one shard, balanced by the
    candidates' valid rank (round-robin over the feature index would let
    clustered candidates overfill one shard)."""
    if group is None:
        return insert_mask
    rank = torch.cumsum(insert_mask.to(torch.int32), dim=0) - 1
    return insert_mask & (rank % axis_size(group) == axis_index(group))


def policy_need_triangulation(policy: int, window, map_size):
    """Triangulation policies; ``window`` is oldest-first [3] f32 including
    the current frame's match count."""
    if policy == 2:
        return torch.ones((), dtype=torch.bool, device=window.device)
    if policy == 3:
        return map_size < 1000
    ratio = 0.99
    return (window[1] <= ratio * window[0]) & (window[2] <= ratio * window[1])


def _cam(cam) -> dict:
    return dict(zip(CAM_KEYS, cam))


def _floats(*xs) -> ctypes.Array:
    return (ctypes.c_float * len(xs))(*map(float, xs))


def _ptrs(*ts) -> list[int]:
    return [t.data_ptr() for t in ts]


def _register(name: str, cpu, fake, n_tensors: int) -> None:
    kernels.register_stream_op(sys.modules[__name__], name, cpu, fake,
                               n_tensors)


def _check_device(t: torch.Tensor, name: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")


def _require_k(k: int) -> None:
    if k > MAX_K:
        raise ValueError(f"K={k} feature slots exceed the kernels' {MAX_K}")


@functools.lru_cache(maxsize=None)
def cluster_size(name: str, device: int, s: int, k: int, m: int, n: int,
                 rgbd: bool = False) -> int:
    """Blocks per stream of op ``name``'s launch (``staged_promote``:
    ``n`` staged points, ``m`` map slots, ``k`` features;
    ``triangulate_insert``: ``k`` features, ``m`` and ``n`` slots) on CUDA
    device ``device``: the largest of CLUSTERS at which the card runs all
    ``s`` streams' clusters at once (cudaOccupancyMaxActiveClusters at the
    shape's shared memory), else the largest it runs at all. Asked once per
    shape, in the first (eager) frame, before any capture."""
    with torch.cuda.device(device):
        fits = {c: kernels.lib().lvt_track_max_clusters(
            _CLUSTER_OPS.index(name), c, k, m, n, int(rgbd))
            for c in CLUSTERS}
    runs = [c for c in CLUSTERS if fits[c] > 0]
    if not runs:
        raise ValueError(f"{name}: K={k}, M={m}, N={n} exceed a block's "
                         f"shared memory at every cluster size {CLUSTERS}")
    return next((c for c in runs if fits[c] >= s), runs[0])


# ---- K1: lvt_tpu_torch::predict_project

def predict_project_plain(motion: MotionState, pose: Pose, is_init, map_pos,
                          map_valid, cam: dict):
    """The motion model's update and prediction from the last pose, the
    identity on the init frame (the motion state kept), and the map's
    projection at the prediction. Returns (motion', predicted, uv [M, 2],
    visible [M])."""
    identity = Pose.identity(map_pos.device)
    new_motion, predicted = predict_next_pose(motion, pose)
    predicted = select(is_init, identity, predicted)
    new_motion = select(is_init, motion, new_motion)
    uv, visible = matching.project_visible(map_pos, map_valid, predicted,
                                           **cam)
    return new_motion, predicted, uv, visible


def _predict_project_flat(lq, lp, lv, av, t, q, is_init, pos, valid, cam):
    motion, pred, uv, vis = predict_project_plain(
        MotionState(lq, lp, lv, av), Pose(t, q), is_init, pos, valid,
        _cam(cam))
    return torch.cat(list(motion)), torch.cat(list(pred)), uv, vis


@torch.library.custom_op("lvt_tpu_torch::predict_project", mutates_args=(),
                         device_types="cuda")
def predict_project_op(last_q: torch.Tensor, last_position: torch.Tensor,
                       linear_velocity: torch.Tensor,
                       angular_velocity: torch.Tensor, t: torch.Tensor,
                       q: torch.Tensor, is_init: torch.Tensor,
                       map_pos: torch.Tensor, map_valid: torch.Tensor,
                       cam: list[float]
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """S streams: the motion state (last_q [S, 4], last_position [S, 3],
    linear_velocity [S, 3], angular_velocity [S, 4]), the last pose (t [S,
    3], q [S, 4]), is_init [S] bool, the map's positions [S, M, 3] and
    validity [S, M] bool, the camera (CAM_KEYS) -> motion' [S, 14] (the
    four leaves in order), predicted pose [S, 7] (t, q), uv [S, M, 2],
    visible [S, M] bool.

    CUDA: one launch of ``csrc/track.cu``'s ``predict_project_kernel``,
    grid (point blocks of 128, S); every thread issues its point's loads
    and the stream's pose inputs, then builds the pose algebra itself (no
    shared memory, no barrier)."""
    s, m = map_pos.shape[0], map_pos.shape[1]
    dev = map_pos.device
    for x, name, shape in ((last_q, "last_q", (s, 4)),
                           (last_position, "last_position", (s, 3)),
                           (linear_velocity, "linear_velocity", (s, 3)),
                           (angular_velocity, "angular_velocity", (s, 4)),
                           (t, "t", (s, 3)), (q, "q", (s, 4)),
                           (map_pos, "map_pos", (s, m, 3))):
        kernels.require(x, name, torch.float32, shape, dev)
    kernels.require(is_init, "is_init", torch.bool, (s,), dev)
    kernels.require(map_valid, "map_valid", torch.bool, (s, m), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    motion = torch.empty((s, 14), **f32)
    pred = torch.empty((s, 7), **f32)
    uv = torch.empty((s, m, 2), **f32)
    vis = torch.empty((s, m), dtype=torch.bool, device=dev)
    err = kernels.lib().lvt_predict_project(
        *_ptrs(last_q, last_position, linear_velocity, angular_velocity, t, q,
               is_init, map_pos, map_valid), s, m, _floats(*cam),
        *_ptrs(motion, pred, uv, vis), kernels.stream_ptr(map_pos))
    kernels.check(err, "predict_project")
    predict_project.launches += 1
    return motion, pred, uv, vis


def _predict_project_fake(lq, lp, lv, av, t, q, is_init, pos, valid, cam):
    s, m = pos.shape[0], pos.shape[1]
    return (pos.new_empty((s, 14)), pos.new_empty((s, 7)),
            pos.new_empty((s, m, 2)), valid.new_empty((s, m)))


_register("predict_project",
          lambda *a: kernels.per_stream(_predict_project_flat, 9, a),
          _predict_project_fake, 9)


def predict_project(motion: MotionState, pose: Pose, is_init, map_pos,
                    map_valid, cam: dict, group=None):
    """:func:`predict_project_plain` for one stream: CPU tensors take the
    plain version, CUDA tensors the kernel, and under ``torch.func.vmap``
    one launch serves every stream. With a ``group`` the same, on the
    rank's block of the map: the op reduces nothing over the points."""
    _check_device(map_pos, "map_pos")
    mo, pred, uv, vis = predict_project_op(
        *(x[None] for x in (*motion, *pose, is_init, map_pos, map_valid)),
        [float(cam[key]) for key in CAM_KEYS])
    mo, pred = mo[0], pred[0]
    return (MotionState(mo[0:4], mo[4:7], mo[7:10], mo[10:14]),
            Pose(pred[0:3], pred[3:7]), uv[0], vis[0])


predict_project.launches = 0


# ---- K2: lvt_tpu_torch::upkeep_pre

class Upkeep(NamedTuple):
    bookkept: PointStore        # the map after the match bookkeeping
    clean: PointStore           # ... and the cull of untracked points
    feature_matched: torch.Tensor   # [K] the map's claims less the culled
    staged_targets: torch.Tensor    # [K] valid and unclaimed features
    map_size: torch.Tensor      # [] int64 valid points of ``clean``
    pose: Pose                  # PnP's pose, the identity on the init frame
    staged_uv: torch.Tensor     # [N, 2] the staged points' projection
    staged_visible: torch.Tensor    # [N] bool


def upkeep_pre_plain(store: PointStore, match_idx, feature_matched,
                     feat_valid, pnp_pose: Pose, is_init, staged_pos,
                     staged_valid, untracked_threshold: int, cam: dict,
                     group=None) -> Upkeep:
    """The map's bookkeeping and cull after the map match, the frame's pose
    (PnP's, or the identity on the init frame), and the staged points'
    projection at it (empty staged inputs: no staged set)."""
    bookkept = map_ops.apply_match_bookkeeping(store, match_idx)
    clean, feature_matched = map_ops.clean_untracked(
        bookkept, match_idx, feature_matched, untracked_threshold, group)
    pose = select(is_init, Pose.identity(store.valid.device), pnp_pose)
    uv, visible = matching.project_visible(staged_pos, staged_valid, pose,
                                           **cam)
    return Upkeep(bookkept, clean, feature_matched,
                  feat_valid & ~feature_matched,
                  psum_if(clean.size(), group), pose, uv, visible)


def _upkeep_pre_flat(counter, age, valid, match_idx, fm, feat_valid, t, q,
                     is_init, staged_pos, staged_valid, threshold, cam):
    store = PointStore(None, None, counter, age, valid)
    u = upkeep_pre_plain(store, match_idx, fm, feat_valid, Pose(t, q),
                         is_init, staged_pos, staged_valid, threshold,
                         _cam(cam))
    return (u.bookkept.counter, u.bookkept.age, u.clean.valid,
            u.feature_matched, u.staged_targets, u.map_size,
            torch.cat(list(u.pose)), u.staged_uv, u.staged_visible)


@torch.library.custom_op("lvt_tpu_torch::upkeep_pre", mutates_args=(),
                         device_types="cuda")
def upkeep_pre_op(counter: torch.Tensor, age: torch.Tensor,
                  valid: torch.Tensor, match_idx: torch.Tensor,
                  feature_matched: torch.Tensor, feat_valid: torch.Tensor,
                  t: torch.Tensor, q: torch.Tensor, is_init: torch.Tensor,
                  staged_pos: torch.Tensor, staged_valid: torch.Tensor,
                  untracked_threshold: int, cam: list[float]
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor, torch.Tensor]:
    """S streams: the map's counter, age [S, M] int32 and validity [S, M]
    bool, the map match's match_idx [S, M] int64 and claims [S, K] bool, the
    features' validity [S, K] bool, PnP's pose (t [S, 3], q [S, 4]),
    is_init [S] bool, the staged positions [S, N, 3] and validity [S, N]
    (N = 0: no staged set), the cull threshold, the camera (CAM_KEYS) ->
    counter', age' [S, M] int32, the culled validity [S, M] bool, claims'
    [S, K] bool, the staged match's targets [S, K] bool, map size [S]
    int64, pose [S, 7], the staged uv [S, N, 2] and visible [S, N] bool.

    CUDA: one launch of ``csrc/track.cu``'s ``upkeep_pre_kernel``, one
    block per stream (the un-marks in shared memory)."""
    s, m = counter.shape[0], counter.shape[1]
    k, n = feature_matched.shape[1], staged_pos.shape[1]
    _require_k(k)
    dev = counter.device
    for x, name, dtype, shape in (
            (counter, "counter", torch.int32, (s, m)),
            (age, "age", torch.int32, (s, m)),
            (valid, "valid", torch.bool, (s, m)),
            (match_idx, "match_idx", torch.int64, (s, m)),
            (feature_matched, "feature_matched", torch.bool, (s, k)),
            (feat_valid, "feat_valid", torch.bool, (s, k)),
            (t, "t", torch.float32, (s, 3)), (q, "q", torch.float32, (s, 4)),
            (is_init, "is_init", torch.bool, (s,)),
            (staged_pos, "staged_pos", torch.float32, (s, n, 3)),
            (staged_valid, "staged_valid", torch.bool, (s, n))):
        kernels.require(x, name, dtype, shape, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    outs = (torch.empty((s, m), **i32), torch.empty((s, m), **i32),
            torch.empty((s, m), **b8), torch.empty((s, k), **b8),
            torch.empty((s, k), **b8),
            torch.empty((s,), dtype=torch.int64, device=dev),
            torch.empty((s, 7), dtype=torch.float32, device=dev),
            torch.empty((s, n, 2), dtype=torch.float32, device=dev),
            torch.empty((s, n), **b8))
    err = kernels.lib().lvt_upkeep_pre(
        *_ptrs(counter, age, valid, match_idx, feature_matched, feat_valid,
               t, q, is_init, staged_pos, staged_valid), s, m, k, n,
        int(untracked_threshold), _floats(*cam), *_ptrs(*outs),
        kernels.stream_ptr(counter))
    kernels.check(err, "upkeep_pre")
    upkeep_pre.launches += 1
    return outs


def _upkeep_pre_fake(counter, age, valid, match_idx, fm, feat_valid, t, q,
                     is_init, staged_pos, staged_valid, threshold, cam):
    s, m = counter.shape
    k, n = fm.shape[1], staged_pos.shape[1]
    return (counter.new_empty((s, m)), counter.new_empty((s, m)),
            valid.new_empty((s, m)), fm.new_empty((s, k)),
            fm.new_empty((s, k)), match_idx.new_empty((s,)),
            t.new_empty((s, 7)), t.new_empty((s, n, 2)),
            valid.new_empty((s, n)))


_register("upkeep_pre",
          lambda *a: kernels.per_stream(_upkeep_pre_flat, 11, a),
          _upkeep_pre_fake, 11)


def upkeep_pre(store: PointStore, match_idx, feature_matched, feat_valid,
               pnp_pose: Pose, is_init, staged: PointStore | None,
               untracked_threshold: int, cam: dict, group=None) -> Upkeep:
    """:func:`upkeep_pre_plain` for one stream (``staged`` None: no staged
    set), as :func:`predict_project` dispatches. With a ``group`` the
    kernel runs on the rank's block, then the plain version's two
    collectives on its outputs: the features this rank's cull un-marked
    (``feature_matched & ~`` its claims', the claims being the same on
    every rank) OR-reduced, the claims and the staged targets recomputed
    from them, and the map size summed."""
    if staged is None:
        staged_pos, staged_valid = store.pos[:0], store.valid[:0]
    else:
        staged_pos, staged_valid = staged.pos, staged.valid
    _check_device(store.pos, "store.pos")
    (counter, age, valid, fm, targets, size, pose, uv,
     vis) = (x[0] for x in upkeep_pre_op(
         *(x[None] for x in (store.counter, store.age, store.valid,
                             match_idx, feature_matched, feat_valid,
                             *pnp_pose, is_init, staged_pos, staged_valid)),
         int(untracked_threshold), [float(cam[key]) for key in CAM_KEYS]))
    if group is not None:
        fm = feature_matched & ~por_if(feature_matched & ~fm, group)
        targets = feat_valid & ~fm
        size = psum_if(size, group)
    bookkept = store._replace(counter=counter, age=age)
    return Upkeep(bookkept, bookkept._replace(valid=valid), fm, targets,
                  size, Pose(pose[0:3], pose[3:7]), uv, vis)


upkeep_pre.launches = 0


# ---- K3: lvt_tpu_torch::staged_promote

class Promotion(NamedTuple):
    staged: PointStore          # the staged set after the re-match
    feature_matched: torch.Tensor   # [K] with the staged claims
    map: PointStore             # the map with the promoted points
    taken: torch.Tensor         # [M] bool map slots filled by promotions


def staged_promote_plain(top2, staged: PointStore, feature_matched, map_size,
                         store: PointStore, *, ratio_threshold: float,
                         abs_threshold: float, staged_threshold: int,
                         map_soft_cap: int, group=None) -> Promotion:
    """The staged re-match from its top-2 (kernel T at the staged
    points): acceptance, one-to-one resolution and claims; misses are
    deleted, survivors counted and promoted into the map's free slots."""
    d1, d2, best, n_cand = top2
    k = feature_matched.shape[0]
    idx = hamming.accept_matches(d1, d2, best, n_cand, ratio_threshold,
                                 abs_threshold)
    idx = hamming.resolve_one_to_one(idx, d1, k, group)
    matched = idx >= 0
    feature_matched = feature_matched | por_if(hamming.claim_mask(idx, k),
                                               group)
    ctr = torch.where(matched, staged.counter + 1, staged.counter)
    promote = staged.valid & matched & (
        (staged.counter + 1 == staged_threshold) | (map_size < map_soft_cap))
    staged_out = staged._replace(counter=ctr,
                                 valid=staged.valid & matched & ~promote)
    ins = map_ops.insert_points(store, staged.pos, staged.desc, promote,
                                new_counter=ctr, new_age=staged.age)
    return Promotion(staged_out, feature_matched, ins.store, ins.taken)


def _staged_promote_flat(d1, d2, best, n_cand, s_pos, s_desc, s_ctr, s_age,
                         s_valid, fm, map_size, m_pos, m_desc, m_ctr, m_age,
                         m_valid, ratio, abs_th, staged_threshold, soft_cap):
    p = staged_promote_plain(
        (d1, d2, best, n_cand),
        PointStore(s_pos, s_desc, s_ctr, s_age, s_valid),
        fm, map_size, PointStore(m_pos, m_desc, m_ctr, m_age, m_valid),
        ratio_threshold=ratio, abs_threshold=abs_th,
        staged_threshold=staged_threshold, map_soft_cap=soft_cap)
    return (p.staged.counter, p.staged.valid, p.feature_matched, *p.map,
            p.taken)


@torch.library.custom_op("lvt_tpu_torch::staged_promote", mutates_args=(),
                         device_types="cuda")
def staged_promote_op(d1: torch.Tensor, d2: torch.Tensor, best: torch.Tensor,
                      n_cand: torch.Tensor, staged_pos: torch.Tensor,
                      staged_desc: torch.Tensor, staged_counter: torch.Tensor,
                      staged_age: torch.Tensor, staged_valid: torch.Tensor,
                      feature_matched: torch.Tensor, map_size: torch.Tensor,
                      map_pos: torch.Tensor, map_desc: torch.Tensor,
                      map_counter: torch.Tensor, map_age: torch.Tensor,
                      map_valid: torch.Tensor, ratio_threshold: float,
                      abs_threshold: float, staged_threshold: int,
                      map_soft_cap: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor, torch.Tensor, torch.Tensor]:
    """S streams: the staged site's top-2 (d1, d2 [S, N] f32, best, n_cand
    [S, N] int64), the staged set (pos [S, N, 3], desc [S, N, 8] int32,
    counter, age [S, N] int32, valid [S, N] bool), the claims [S, K] bool,
    the map size [S] int64 and the map (pos [S, M, 3], ..., valid [S, M])
    -> the staged counter' [S, N] int32 and valid' [S, N], claims' [S, K],
    the map' (pos, desc, counter, age, valid) and the slots taken [S, M].

    CUDA: one launch of ``csrc/track.cu``'s ``staged_promote_kernel``, a
    thread-block cluster of :func:`cluster_size` blocks per stream, each
    block a range of the staged points, of the features (the resolution's
    targets) and of the map's slots: the resolution's minimum per feature
    an atomicMin in its owner's shared memory, the promotions compacted
    and the free slots ranked by prefix sums in index order, within a
    block and over the blocks' counts in rank order."""
    s, n = staged_pos.shape[0], staged_pos.shape[1]
    m, k = map_pos.shape[1], feature_matched.shape[1]
    _require_k(k)
    dev = map_pos.device
    words = hamming.DESC_WORDS
    for x, name, dtype, shape in (
            (d1, "d1", torch.float32, (s, n)),
            (d2, "d2", torch.float32, (s, n)),
            (best, "best", torch.int64, (s, n)),
            (n_cand, "n_cand", torch.int64, (s, n)),
            (staged_pos, "staged_pos", torch.float32, (s, n, 3)),
            (staged_desc, "staged_desc", torch.int32, (s, n, words)),
            (staged_counter, "staged_counter", torch.int32, (s, n)),
            (staged_age, "staged_age", torch.int32, (s, n)),
            (staged_valid, "staged_valid", torch.bool, (s, n)),
            (feature_matched, "feature_matched", torch.bool, (s, k)),
            (map_size, "map_size", torch.int64, (s,)),
            (map_pos, "map_pos", torch.float32, (s, m, 3)),
            (map_desc, "map_desc", torch.int32, (s, m, words)),
            (map_counter, "map_counter", torch.int32, (s, m)),
            (map_age, "map_age", torch.int32, (s, m)),
            (map_valid, "map_valid", torch.bool, (s, m))):
        kernels.require(x, name, dtype, shape, dev)
    outs = (torch.empty_like(staged_counter), torch.empty_like(staged_valid),
            torch.empty_like(feature_matched), torch.empty_like(map_pos),
            torch.empty_like(map_desc), torch.empty_like(map_counter),
            torch.empty_like(map_age), torch.empty_like(map_valid),
            torch.empty_like(map_valid))
    cluster = cluster_size("staged_promote", dev.index, s, k, m, n)
    with torch.cuda.device(dev):
        err = kernels.lib().lvt_staged_promote(
            *_ptrs(d1, d2, best, n_cand, staged_pos, staged_desc,
                   staged_counter, staged_age, staged_valid, feature_matched,
                   map_size, map_pos, map_desc, map_counter, map_age,
                   map_valid), s, n, m, k, float(ratio_threshold),
            float(abs_threshold), int(staged_threshold), int(map_soft_cap),
            cluster, *_ptrs(*outs), kernels.stream_ptr(map_pos))
    kernels.check(err, "staged_promote")
    staged_promote.launches += 1
    return outs


def _staged_promote_fake(d1, d2, best, n_cand, s_pos, s_desc, s_ctr, s_age,
                         s_valid, fm, map_size, m_pos, m_desc, m_ctr, m_age,
                         m_valid, *scalars):
    return (torch.empty_like(s_ctr), torch.empty_like(s_valid),
            torch.empty_like(fm), torch.empty_like(m_pos),
            torch.empty_like(m_desc), torch.empty_like(m_ctr),
            torch.empty_like(m_age), torch.empty_like(m_valid),
            torch.empty_like(m_valid))


_register("staged_promote",
          lambda *a: kernels.per_stream(_staged_promote_flat, 16, a),
          _staged_promote_fake, 16)


def staged_promote(top2, staged: PointStore, feature_matched, map_size,
                   store: PointStore, *, ratio_threshold: float,
                   abs_threshold: float, staged_threshold: int,
                   map_soft_cap: int, group=None) -> Promotion:
    """:func:`staged_promote_plain` for one stream, as
    :func:`predict_project` dispatches."""
    kw = dict(ratio_threshold=ratio_threshold, abs_threshold=abs_threshold,
              staged_threshold=staged_threshold, map_soft_cap=map_soft_cap)
    if group is not None:
        return staged_promote_plain(top2, staged, feature_matched, map_size,
                                    store, group=group, **kw)
    _check_device(store.pos, "store.pos")
    out = [x[0] for x in staged_promote_op(
        *(x[None] for x in (*top2, *staged, feature_matched, map_size,
                            *store)),
        float(ratio_threshold), float(abs_threshold), int(staged_threshold),
        int(map_soft_cap))]
    return Promotion(staged._replace(counter=out[0], valid=out[1]), out[2],
                     PointStore(*out[3:8]), out[8])


staged_promote.launches = 0


# ---- K4: lvt_tpu_torch::triangulate_insert

class Insertion(NamedTuple):
    map: PointStore             # the map with the new points
    map_taken: torch.Tensor     # [M] bool map slots filled
    staged: PointStore          # the staged set with the new points
    n_inserted: torch.Tensor    # [] int64 points inserted, map + staged
    map_size: torch.Tensor      # [] int64 valid points of the new map
    window: torch.Tensor        # [3] f32 the match-count window
    points: torch.Tensor        # [K, 3] each feature's world point
    valid: torch.Tensor         # [K] bool the insertion candidates


class TriangulationParams(NamedTuple):
    """The config's scalars that triangulate_insert reads."""
    ratio_threshold: float      # the row match's ratio test
    abs_threshold: float
    baseline: float
    reprojection_th2: float
    policy: int
    staged_threshold: int
    map_soft_cap: int

    @staticmethod
    def of(config) -> "TriangulationParams":
        return TriangulationParams(
            config.triangulation_ratio_test_threshold,
            config.descriptor_matching_threshold, config.baseline,
            config.reprojection_th2, config.triangulation_policy,
            config.staged_threshold, config.map_soft_cap)


def triangulate_insert_plain(row_top2, kp, right_kp, depth, feat_valid,
                             desc, pose: Pose, store: PointStore,
                             staged: PointStore, last_matches,
                             matches_count, is_init, cam: dict,
                             prm: TriangulationParams,
                             group=None) -> Insertion:
    """New points from this frame: stereo (``row_top2`` the row match's
    top-2 under kernel T: acceptance and resolution, then triangulation of
    the matched pairs) or RGB-D (``row_top2`` None: every valid feature
    back-projected at its ``depth``); the triangulation policy on the match
    window and the map size; the candidates inserted into the map under
    its soft cap, else into the staged set. With a ``group``, each rank
    inserts its share of the candidates and the sizes are summed."""
    if row_top2 is None:
        res = triangulate.backproject_rgbd(
            kp, depth, feat_valid, pose, fx=cam["fx"], fy=cam["fy"],
            cx=cam["cx"], cy=cam["cy"])
    else:
        d1, d2, best, n_cand = row_top2
        k = kp.shape[0]
        idx = hamming.accept_matches(d1, d2, best, n_cand,
                                     prm.ratio_threshold, prm.abs_threshold)
        idx = hamming.resolve_one_to_one(idx, d1, k)
        uv_right = right_kp[torch.clamp(idx, 0, k - 1)]
        res = triangulate.triangulate_stereo(
            kp, uv_right, idx >= 0, pose, baseline=prm.baseline,
            reprojection_th2=prm.reprojection_th2, **cam)
    window = torch.cat([last_matches[1:], matches_count[None].float()])
    map_size = psum_if(store.size(), group)
    need_tri = (policy_need_triangulation(prm.policy, window, map_size)
                | is_init)
    valid = shard_partition_mask(res.valid & need_tri, group)
    to_map = (map_size < prm.map_soft_cap) | (prm.staged_threshold == 0)
    ins_map = map_ops.insert_points(store, res.points_world, desc,
                                    valid & to_map)
    ins_staged = map_ops.insert_points(staged, res.points_world, desc,
                                       valid & ~to_map)
    map_size_final = psum_if(ins_map.store.size(), group)
    init_window = torch.stack([
        map_size_final.float(),
        torch.full((), MATCHES_WINDOW_INIT, device=window.device),
        torch.full((), MATCHES_WINDOW_INIT, device=window.device)])
    return Insertion(
        ins_map.store, ins_map.taken, ins_staged.store,
        psum_if(ins_map.n_inserted + ins_staged.n_inserted, group),
        map_size_final, torch.where(is_init, init_window, window),
        res.points_world, valid)


def _triangulate_insert_flat(d1, d2, best, n_cand, kp, right_kp, depth,
                             feat_valid, desc, t, q, m_pos, m_desc, m_ctr,
                             m_age, m_valid, s_pos, s_desc, s_ctr, s_age,
                             s_valid, last_matches, matches_count, is_init,
                             rgbd, cam, prm):
    ins = triangulate_insert_plain(
        None if rgbd else (d1, d2, best, n_cand), kp, right_kp, depth,
        feat_valid, desc, Pose(t, q),
        PointStore(m_pos, m_desc, m_ctr, m_age, m_valid),
        PointStore(s_pos, s_desc, s_ctr, s_age, s_valid), last_matches,
        matches_count, is_init, _cam(cam[:len(CAM_KEYS)]),
        _params(cam, prm))
    return (*ins.map, ins.map_taken, *ins.staged, ins.n_inserted,
            ins.map_size, ins.window, ins.points, ins.valid)


def _params(fl, ints) -> TriangulationParams:
    """The op's float list (CAM_KEYS, then ratio, abs, baseline, th2) and
    int list (policy, staged_threshold, map_soft_cap) as the params."""
    n = len(CAM_KEYS)
    return TriangulationParams(*fl[n:n + 4], *ints)


@torch.library.custom_op("lvt_tpu_torch::triangulate_insert",
                         mutates_args=(), device_types="cuda")
def triangulate_insert_op(
        d1: torch.Tensor, d2: torch.Tensor, best: torch.Tensor,
        n_cand: torch.Tensor, kp: torch.Tensor, right_kp: torch.Tensor,
        depth: torch.Tensor, feat_valid: torch.Tensor, desc: torch.Tensor,
        t: torch.Tensor, q: torch.Tensor, map_pos: torch.Tensor,
        map_desc: torch.Tensor,
        map_counter: torch.Tensor, map_age: torch.Tensor,
        map_valid: torch.Tensor, staged_pos: torch.Tensor,
        staged_desc: torch.Tensor, staged_counter: torch.Tensor,
        staged_age: torch.Tensor, staged_valid: torch.Tensor,
        last_matches: torch.Tensor, matches_count: torch.Tensor,
        is_init: torch.Tensor, rgbd: bool, floats: list[float],
        ints: list[int]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """S streams: the row site's top-2 (d1, d2 [S, K] f32, best, n_cand
    [S, K] int64; [S, 0] with ``rgbd``), the left keypoints [S, K, 2], the
    right ones [S, K, 2] (or [S, 0, 2]), the depth [S, K] (``rgbd``; else
    [S, 0]), the left features' validity [S, K] bool (read with ``rgbd``)
    and descriptors [S, K, 8], the pose (t [S, 3], q [S, 4]),
    the map and the staged set (pos, desc, counter, age, valid; [S, M] and
    [S, N]), last_matches [S, 3] f32, the match count [S] int64, is_init
    [S] bool; ``floats`` CAM_KEYS then the row ratio and absolute
    thresholds, the baseline and reprojection_th2, ``ints`` the policy,
    staged_threshold and map_soft_cap -> the map' (5 leaves), its slots
    taken [S, M], the staged set' (5 leaves), the points inserted [S]
    int64, the map size [S] int64, the window [S, 3], the world points
    [S, K, 3] and the candidates [S, K] bool.

    CUDA: one launch of ``csrc/track.cu``'s ``triangulate_insert_kernel``,
    a thread-block cluster of :func:`cluster_size` blocks per stream, each
    block a range of the features (as queries and as the row resolution's
    targets) and of the map's and the staged set's slots: the row
    resolution's atomicMin in the target owner's shared memory, the
    triangulation per feature in the plain version's order (its float64
    multiply-add chains included), the candidates compacted and the free
    slots ranked by prefix sums in index order, within a block and over
    the blocks' counts in rank order."""
    s, k = kp.shape[0], kp.shape[1]
    m, n = map_pos.shape[1], staged_pos.shape[1]
    _require_k(k)
    dev = kp.device
    words = hamming.DESC_WORDS
    kr = 0 if rgbd else k
    f32, i64, i32 = torch.float32, torch.int64, torch.int32
    for x, name, dtype, shape in (
            (d1, "d1", f32, (s, kr)), (d2, "d2", f32, (s, kr)),
            (best, "best", i64, (s, kr)), (n_cand, "n_cand", i64, (s, kr)),
            (kp, "kp", f32, (s, k, 2)),
            (right_kp, "right_kp", f32, (s, kr, 2)),
            (depth, "depth", f32, (s, k - kr)),
            (feat_valid, "feat_valid", torch.bool, (s, k)),
            (desc, "desc", i32, (s, k, words)), (t, "t", f32, (s, 3)),
            (q, "q", f32, (s, 4)),
            (map_pos, "map_pos", f32, (s, m, 3)),
            (map_desc, "map_desc", i32, (s, m, words)),
            (map_counter, "map_counter", i32, (s, m)),
            (map_age, "map_age", i32, (s, m)),
            (map_valid, "map_valid", torch.bool, (s, m)),
            (staged_pos, "staged_pos", f32, (s, n, 3)),
            (staged_desc, "staged_desc", i32, (s, n, words)),
            (staged_counter, "staged_counter", i32, (s, n)),
            (staged_age, "staged_age", i32, (s, n)),
            (staged_valid, "staged_valid", torch.bool, (s, n)),
            (last_matches, "last_matches", f32, (s, 3)),
            (matches_count, "matches_count", i64, (s,)),
            (is_init, "is_init", torch.bool, (s,))):
        kernels.require(x, name, dtype, shape, dev)
    outs = (torch.empty_like(map_pos), torch.empty_like(map_desc),
            torch.empty_like(map_counter), torch.empty_like(map_age),
            torch.empty_like(map_valid), torch.empty_like(map_valid),
            torch.empty_like(staged_pos), torch.empty_like(staged_desc),
            torch.empty_like(staged_counter), torch.empty_like(staged_age),
            torch.empty_like(staged_valid),
            torch.empty((s,), dtype=i64, device=dev),
            torch.empty((s,), dtype=i64, device=dev),
            torch.empty((s, 3), dtype=f32, device=dev),
            torch.empty((s, k, 3), dtype=f32, device=dev),
            torch.empty((s, k), dtype=torch.bool, device=dev))
    cluster = cluster_size("triangulate_insert", dev.index, s, k, m, n,
                           bool(rgbd))
    with torch.cuda.device(dev):
        err = kernels.lib().lvt_triangulate_insert(
            *_ptrs(d1, d2, best, n_cand, kp, right_kp, depth, feat_valid,
                   desc, t, q, map_pos, map_desc, map_counter, map_age,
                   map_valid, staged_pos, staged_desc, staged_counter,
                   staged_age, staged_valid, last_matches, matches_count,
                   is_init), s, k, m, n, int(rgbd), _floats(*floats),
            *(int(i) for i in ints), float(MATCHES_WINDOW_INIT), cluster,
            *_ptrs(*outs), kernels.stream_ptr(kp))
    kernels.check(err, "triangulate_insert")
    triangulate_insert.launches += 1
    return outs


def _triangulate_insert_fake(d1, d2, best, n_cand, kp, right_kp, depth,
                             feat_valid, desc, t, q, m_pos, m_desc, m_ctr,
                             m_age, m_valid, s_pos, s_desc, s_ctr, s_age,
                             s_valid, last_matches, matches_count, is_init,
                             rgbd, floats, ints):
    s, k = kp.shape[0], kp.shape[1]
    return (*(torch.empty_like(x) for x in (m_pos, m_desc, m_ctr, m_age,
                                            m_valid, m_valid, s_pos, s_desc,
                                            s_ctr, s_age, s_valid)),
            matches_count.new_empty((s,)), matches_count.new_empty((s,)),
            last_matches.new_empty((s, 3)), kp.new_empty((s, k, 3)),
            feat_valid.new_empty((s, k)))


_register("triangulate_insert",
          lambda *a: kernels.per_stream(_triangulate_insert_flat, 24, a),
          _triangulate_insert_fake, 24)


def triangulate_insert(row_top2, left, right, pose: Pose, store: PointStore,
                       staged: PointStore, last_matches, matches_count,
                       is_init, cam: dict, prm: TriangulationParams,
                       group=None) -> Insertion:
    """:func:`triangulate_insert_plain` for one stream's features (``left``,
    and ``right`` None for RGB-D, where ``left.depth`` is read), as
    :func:`predict_project` dispatches."""
    rgbd = right is None
    right_kp, depth = (None, left.depth) if rgbd else (right.kp, None)
    if group is not None:
        return triangulate_insert_plain(
            row_top2, left.kp, right_kp, depth, left.valid, left.desc, pose,
            store, staged, last_matches, matches_count, is_init, cam, prm,
            group)
    _check_device(left.kp, "left.kp")
    if rgbd:
        empty = left.kp[:0, 0]
        row_top2 = (empty, empty, empty.long(), empty.long())
        right_kp = left.kp[:0]
    else:
        depth = left.kp[:0, 0]
    out = [x[0] for x in triangulate_insert_op(
        *(x[None] for x in (*row_top2, left.kp, right_kp, depth, left.valid,
                            left.desc, *pose, *store,
                            *staged, last_matches, matches_count, is_init)),
        rgbd, [*(float(cam[key]) for key in CAM_KEYS),
               float(prm.ratio_threshold), float(prm.abs_threshold),
               float(prm.baseline), float(prm.reprojection_th2)],
        [int(prm.policy), int(prm.staged_threshold), int(prm.map_soft_cap)])]
    return Insertion(PointStore(*out[0:5]), out[5], PointStore(*out[6:11]),
                     *out[11:])


triangulate_insert.launches = 0


# ---- K6: lvt_tpu_torch::ba_observe

def ba_observe_plain(row_b, match_idx, obs, weights, right_kp, pose: Pose,
                     ba: ObsWindow, map_valid, bookkept_valid, clean_valid,
                     map_taken, promo_taken, frame_number, *,
                     ratio_threshold: float, abs_threshold: float,
                     local_ba_every: int):
    """Local BA's observations of this frame and the window's slide: the
    BA row match from its top-2 (``row_b``: kernel T's second row set, the
    map-matched features; acceptance and one-to-one resolution over the
    right features), each map slot's right observation (the right keypoint
    of its feature's row match, right feature 0's where none) and weight;
    without a right camera (``right_kp`` [0, 2]) both zero, BA inert. The
    window slides by this frame (PnP's pose, the map match's observations
    ``obs`` and ``weights``), its weights cleared at the slots that are not
    alive (invalid, culled, ``map_taken`` or ``promo_taken``: recycled;
    ``promo_taken`` None without a staged set), ``n`` saturating at the
    window; BA is due where the window is full and ``frame_number`` is a
    multiple of ``local_ba_every``. Returns (window', do_ba)."""
    f = ba.poses_t.shape[0]
    k = right_kp.shape[0]
    if k == 0:
        obs_r, w_r = torch.zeros_like(obs), torch.zeros_like(weights)
    else:
        d1, d2, best, n_cand = row_b
        idx = hamming.accept_matches(d1, d2, best, n_cand, ratio_threshold,
                                     abs_threshold)
        idx = hamming.resolve_one_to_one(idx, d1, k)
        r_idx = idx[torch.clamp(match_idx, 0, k - 1)]
        obs_r = right_kp[torch.clamp(r_idx, 0, k - 1)]
        w_r = ((match_idx >= 0) & (r_idx >= 0)).float()
    removed = bookkept_valid & ~clean_valid
    recycled = map_taken if promo_taken is None else map_taken | promo_taken
    alive = (map_valid & ~(removed | recycled))[None, :].float()

    def slide(old, new):
        return torch.cat([old[1:], new[None]], 0)

    window = ObsWindow(
        poses_t=slide(ba.poses_t, pose.t), poses_q=slide(ba.poses_q, pose.q),
        obs=slide(ba.obs, obs), w=slide(ba.w, weights) * alive,
        obs_r=slide(ba.obs_r, obs_r), w_r=slide(ba.w_r, w_r) * alive,
        n=torch.clamp(ba.n + 1, max=f))
    do_ba = (window.n >= f) & (frame_number % local_ba_every == 0)
    return window, do_ba


def _ba_observe_flat(fout, iout, match_idx, obs, weights, right_kp, t, q,
                     poses_t, poses_q, w_obs, w_w, w_obs_r, w_w_r, n,
                     map_valid, bookkept_valid, clean_valid, map_taken,
                     promo_taken, frame_number, ratio, abs_th, every):
    window, do_ba = ba_observe_plain(
        top2._unpack(fout, iout)[1], match_idx, obs, weights, right_kp,
        Pose(t, q), ObsWindow(poses_t, poses_q, w_obs, w_w, w_obs_r, w_w_r,
                              n),
        map_valid, bookkept_valid, clean_valid, map_taken,
        promo_taken if promo_taken.shape[0] else None, frame_number,
        ratio_threshold=ratio, abs_threshold=abs_th, local_ba_every=every)
    return (*window, do_ba)


@torch.library.custom_op("lvt_tpu_torch::ba_observe", mutates_args=(),
                         device_types="cuda")
def ba_observe_op(fout: torch.Tensor, iout: torch.Tensor,
                  match_idx: torch.Tensor, obs: torch.Tensor,
                  weights: torch.Tensor, right_kp: torch.Tensor,
                  t: torch.Tensor, q: torch.Tensor, poses_t: torch.Tensor,
                  poses_q: torch.Tensor, w_obs: torch.Tensor,
                  w_w: torch.Tensor, w_obs_r: torch.Tensor,
                  w_w_r: torch.Tensor, n: torch.Tensor,
                  map_valid: torch.Tensor, bookkept_valid: torch.Tensor,
                  clean_valid: torch.Tensor, map_taken: torch.Tensor,
                  promo_taken: torch.Tensor, frame_number: torch.Tensor,
                  ratio_threshold: float, abs_threshold: float,
                  local_ba_every: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor]:
    """S streams: kernel T's dual row outputs (fout [S, 2, 2, K] f32, iout
    [S, 2, 2, K] int64, ``top2._pack``'s layout; the second set is read;
    K = 0: no right camera), the map match's match_idx [S, M] int64, obs
    [S, M, 2] and weights [S, M] f32, the right keypoints [S, K, 2], PnP's
    pose (t [S, 3], q [S, 4]), the window (poses_t [S, F, 3], poses_q [S,
    F, 4], obs [S, F, M, 2], w [S, F, M], obs_r [S, F, M, 2], w_r [S, F,
    M] f32, n [S] int32), the map's validity after the insertions, after
    the bookkeeping and after the cull, the slots the insertions and the
    promotions took ([S, M] bool; promo_taken [S, 0] without a staged
    set), the frame number [S] int32 -> the window' (its seven leaves) and
    do_ba [S] bool.

    CUDA: one launch of ``csrc/track.cu``'s ``ba_observe_kernel``, grid
    (1 + copy blocks, S): block 0 of a stream (1024 threads) resolves the
    row match over the right features (an atomicMin a target in shared
    memory, two barriers) and writes the window's newest row, its poses,
    ``n`` and ``do_ba``; the copy blocks slide the older rows."""
    s, k = fout.shape[0], fout.shape[3]
    m, f = match_idx.shape[1], poses_t.shape[1]
    _require_k(k)
    if f < 1:
        raise ValueError("ba_observe: the window needs at least one pose")
    if local_ba_every < 1:
        raise ValueError(f"local_ba_every={local_ba_every}: must be >= 1")
    dev = match_idx.device
    f32, b8, i32 = torch.float32, torch.bool, torch.int32
    np_ = promo_taken.shape[1]
    for x, name, dtype, shape in (
            (fout, "fout", f32, (s, 2, 2, k)),
            (iout, "iout", torch.int64, (s, 2, 2, k)),
            (match_idx, "match_idx", torch.int64, (s, m)),
            (obs, "obs", f32, (s, m, 2)), (weights, "weights", f32, (s, m)),
            (right_kp, "right_kp", f32, (s, k, 2)),
            (t, "t", f32, (s, 3)), (q, "q", f32, (s, 4)),
            (poses_t, "poses_t", f32, (s, f, 3)),
            (poses_q, "poses_q", f32, (s, f, 4)),
            (w_obs, "w_obs", f32, (s, f, m, 2)), (w_w, "w_w", f32, (s, f, m)),
            (w_obs_r, "w_obs_r", f32, (s, f, m, 2)),
            (w_w_r, "w_w_r", f32, (s, f, m)), (n, "n", i32, (s,)),
            (map_valid, "map_valid", b8, (s, m)),
            (bookkept_valid, "bookkept_valid", b8, (s, m)),
            (clean_valid, "clean_valid", b8, (s, m)),
            (map_taken, "map_taken", b8, (s, m)),
            (promo_taken, "promo_taken", b8, (s, m if np_ else 0)),
            (frame_number, "frame_number", i32, (s,))):
        kernels.require(x, name, dtype, shape, dev)
    outs = (torch.empty_like(poses_t), torch.empty_like(poses_q),
            torch.empty_like(w_obs), torch.empty_like(w_w),
            torch.empty_like(w_obs_r), torch.empty_like(w_w_r),
            torch.empty_like(n), torch.empty((s,), dtype=b8, device=dev))
    err = kernels.lib().lvt_ba_observe(
        *_ptrs(fout, iout, match_idx, obs, weights, right_kp, t, q, poses_t,
               poses_q, w_obs, w_w, w_obs_r, w_w_r, n, map_valid,
               bookkept_valid, clean_valid, map_taken),
        promo_taken.data_ptr() if np_ else None, frame_number.data_ptr(), s,
        k, m, f, float(ratio_threshold), float(abs_threshold),
        int(local_ba_every), *_ptrs(*outs), kernels.stream_ptr(match_idx))
    kernels.check(err, "ba_observe")
    ba_observe.launches += 1
    return outs


def _ba_observe_fake(fout, iout, match_idx, obs, weights, right_kp, t, q,
                     poses_t, poses_q, w_obs, w_w, w_obs_r, w_w_r, n,
                     *rest):
    return (torch.empty_like(poses_t), torch.empty_like(poses_q),
            torch.empty_like(w_obs), torch.empty_like(w_w),
            torch.empty_like(w_obs_r), torch.empty_like(w_w_r),
            torch.empty_like(n), n.new_empty(n.shape, dtype=torch.bool))


_register("ba_observe",
          lambda *a: kernels.per_stream(_ba_observe_flat, 21, a),
          _ba_observe_fake, 21)


def ba_observe(row_packed, match_idx, obs, weights, right_kp, pose: Pose,
               ba: ObsWindow, map_valid, bookkept_valid, clean_valid,
               map_taken, promo_taken, frame_number, *,
               ratio_threshold: float, abs_threshold: float,
               local_ba_every: int, group=None):
    """:func:`ba_observe_plain` for one stream, from kernel T's packed dual
    row outputs (``row_packed``: (fout, iout); None without a right camera,
    and then ``right_kp`` None), as :func:`predict_project` dispatches.
    Returns (window', do_ba)."""
    kw = dict(ratio_threshold=ratio_threshold, abs_threshold=abs_threshold,
              local_ba_every=local_ba_every)
    if right_kp is None:
        right_kp = obs[:0]
        row_packed = (obs.new_zeros((2, 2, 0)),
                      match_idx.new_zeros((2, 2, 0)))
    _check_device(match_idx, "match_idx")
    if promo_taken is None:
        promo_taken = map_taken[:0]
    out = [x[0] for x in ba_observe_op(
        *(x[None] for x in (*row_packed, match_idx, obs, weights, right_kp,
                            *pose, *ba, map_valid, bookkept_valid,
                            clean_valid, map_taken, promo_taken,
                            frame_number)),
        float(ratio_threshold), float(abs_threshold), int(local_ba_every))]
    return ObsWindow(*out[:7]), out[7]


ba_observe.launches = 0
