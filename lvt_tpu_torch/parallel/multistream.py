"""Multi-stream VO on one card: S independent camera streams as a batch
axis of one step.

Port of lvt_tpu/parallel/multistream.py for one device. Per frame, all 2S
stereo images (or S gray images) go through extraction as one batch, so
kernels A and P (A and B in dense mode) launch once for all streams; the
per-stream state machine is then ``torch.func.vmap`` of the single-stream
body ``core/step.py::track_features`` (lvt_tpu's ``jax.vmap``), in which
kernel T's batching rule (ops/top2.py) makes one launch per site for all
S streams; one tail (core/tail.py) then serves every stream. Per-stream
LOST flags live in the batched VOState, so a lost stream never stalls the
others: the auto-reset re-initializes just its slice, keeping its pose.
The step is captured in one CUDA graph and replayed per frame on the card
(core/graphs.py), the vmapped body and T's batching rule included; the
reset is the runner's, inside the tail's launch on the card
(``tail.reset_lost`` elsewhere).

With a ``("stream",)`` mesh (parallel/mesh.py) the S streams split over
its ranks (processes) in contiguous blocks of S / n, as lvt_tpu's
``P("stream")`` lays them out: each rank holds and tracks its own block,
and no collective runs (streams are independent), so the step is captured
whatever the group's backend.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap
from torch.profiler import record_function as stage

from lvt_tpu_torch.config import VOConfig
from lvt_tpu_torch.core import extract, tail
from lvt_tpu_torch.core import step as step_mod
from lvt_tpu_torch.core.features import FrameFeatures
from lvt_tpu_torch.core.state import VOState
from lvt_tpu_torch.device import resolve_device
from lvt_tpu_torch.ops.collectives import axis_index, axis_size
from lvt_tpu_torch.tree import tree_map


def _initial_state(config: VOConfig, device) -> VOState:
    return VOState.initial(config.max_map_points, config.max_staged_points,
                           config.local_ba_window, device=device)


def batched_initial_state(config: VOConfig, n_streams: int, *,
                          device="cuda") -> VOState:
    """The initial VOState of every stream, each leaf with a leading [S]."""
    return tree_map(lambda x: x[None].expand(n_streams, *x.shape).clone(),
                    _initial_state(config, device))


def local_stream_indices(mesh, n_streams: int) -> np.ndarray:
    """Global indices of the streams this rank holds on a 1-D ``stream``
    mesh: rank k of n owns streams [k * S / n, (k + 1) * S / n), as
    lvt_tpu's ``P("stream")`` lays them out (all S without a mesh)."""
    if mesh is None:
        return np.arange(n_streams)
    if mesh.ndim != 1:
        raise ValueError(f"expected a 1-D stream mesh, got {mesh.ndim}-D")
    group = mesh.get_group(0)
    n = axis_size(group)
    if n_streams % n:
        raise ValueError(f"{n_streams} streams do not divide over {n} ranks")
    per = n_streams // n
    return np.arange(per * axis_index(group), per * (axis_index(group) + 1))


def _split(feats: FrameFeatures, s: int):
    return (FrameFeatures(*(a[:s] for a in feats)),
            FrameFeatures(*(a[s:] for a in feats)))


def _branch(fn):
    """``fn`` (the tracking body of one stream -> (tracked values,
    TailInputs)) with its TailInputs as a tuple without ``ba_ran`` where
    that is None (no local BA), as ``vmap`` returns tensors only."""
    def run(*args):
        new, inp = fn(*args)
        return new, tuple(x for x in inp if x is not None)

    return run


def _tail(states: VOState, branch, config: VOConfig):
    """The tail of every stream after the vmapped body's ``branch`` (its
    tracked values and tail inputs, [S, ...] each, ``_branch``'s form):
    one launch for all."""
    new, inp = branch
    inp = tail.TailInputs(*inp, *[None] * (len(tail.TailInputs._fields)
                                           - len(inp)))
    with stage("step_tail"):
        return tail.step_tail_streams(states, new, inp,
                                      config.min_num_matches_for_tracking)


def multistream_step_stereo(states: VOState, imgs_left: torch.Tensor,
                            imgs_right: torch.Tensor, config: VOConfig):
    """One frame for every stream: [S, H, W] left and right -> (states,
    poses [S], metrics [S]). One extraction over the 2S images, then the
    vmapped tracking body and one tail."""
    step_mod._check_config(config)
    s = imgs_left.shape[0]
    left, right = _split(extract.extract_features_batched(
        torch.cat([imgs_left, imgs_right]), config), s)
    return _tail(states, vmap(_branch(lambda st, lf, rf: step_mod
                                      .track_branch(st, lf, rf, config)))(
        states, left, right), config)


def multistream_step_rgbd(states: VOState, imgs_gray: torch.Tensor,
                          imgs_depth: torch.Tensor, config: VOConfig):
    """One RGB-D frame for every stream: [S, H, W] gray and float32 metric
    depth -> (states, poses [S], metrics [S]). One extraction over the S
    gray images, then per stream (vmapped) the depth lookup and
    tracking, and one tail."""
    step_mod._check_config(config)
    feats = extract.extract_features_batched(imgs_gray, config)

    def one(st, f, depth):
        return step_mod.track_branch(
            st, extract.apply_depth(f, depth, config), None, config)

    return _tail(states, vmap(_branch(one))(states, feats, imgs_depth),
                 config)


def reset_lost_streams(states: VOState, config: VOConfig) -> VOState:
    """Per-stream auto-reset: a stream in LOST is re-initialized in place
    (the ROS shell's reset-on-lost policy). Its accumulated pose is kept,
    so odometry continues from where tracking was lost."""
    return tail.reset_lost(states, _initial_state(config,
                                                  states.status.device))


def multistream_chunk(states: VOState, imgs1: torch.Tensor,
                      imgs2: torch.Tensor, config: VOConfig, runners: dict,
                      auto_reset: bool = True, rgbd: bool = False):
    """N frames of S streams, in order: imgs [N, S, H, W] (left and right,
    or gray and float32 depth); with ``auto_reset`` a lost stream is reset
    after its frame. Runs through the runner in ``runners`` (which writes
    ``states`` in place); returns (states, poses [N, S], metrics [N, S])."""
    step = multistream_step_rgbd if rgbd else multistream_step_stereo
    dev = states.status.device
    return step_mod._scan(
        lambda: lambda st, a, b: step(st, a, b, config),
        states, (imgs1, imgs2), runners, "rgbd" if rgbd else "stereo",
        batched=True,
        make_reset=(lambda: _initial_state(config, dev)) if auto_reset
        else None)


class MultiStreamVO:
    """Driver for a batch of S concurrent VO streams (stereo or RGB-D) on
    one device, or, with a 1-D ``mesh``, over its ranks: each rank then
    takes the whole batch's frames (or only its own block's), tracks its
    block of streams (``local_streams``) and returns their poses."""

    def __init__(self, config: VOConfig, n_streams: int, mesh=None, *,
                 device="cuda", auto_reset: bool = True, rgbd: bool = False):
        config.validate()
        step_mod._check_config(config)
        self.config = config
        self.n_streams = n_streams
        self.mesh = mesh
        self.local_streams = local_stream_indices(mesh, n_streams)
        self.device = resolve_device(device)
        self.auto_reset = auto_reset
        self.rgbd = rgbd
        # static buffers, written in place by the runner and never rebound
        self.states = batched_initial_state(config, len(self.local_streams),
                                            device=self.device)
        self.runners: dict = {}

    def _local(self, a: torch.Tensor) -> torch.Tensor:
        """This rank's streams of a whole batch (axis -3); a block that is
        not the whole batch is taken as this rank's already."""
        if a.ndim < 3 or a.shape[-3] != self.n_streams:
            return a        # the shape check below reports it
        lo, hi = self.local_streams[0], self.local_streams[-1] + 1
        return a if hi - lo == self.n_streams else a[..., lo:hi, :, :]

    def _prep(self, imgs, ndim: int, second: bool) -> torch.Tensor:
        a = self._local(torch.as_tensor(imgs))
        if second and self.rgbd:
            a = a.to(self.device, torch.float32)     # metric depth
        else:
            # uint8 uploads 4x less than f32 and kernel A widens on the card
            a = a.to(self.device)
            a = a if a.dtype == torch.uint8 else a.float()
        hw = (self.config.img_height, self.config.img_width)
        n = len(self.local_streams)
        if a.ndim != ndim or a.shape[-3] != n or tuple(a.shape[-2:]) != hw:
            raise ValueError(f"expected {ndim}-d images of [{self.n_streams}, "
                             f"{hw[0]}, {hw[1]}], got {tuple(a.shape)}")
        return a

    def track(self, imgs1, imgs2):
        """One frame per stream: imgs [S, H, W], stereo (left, right) or
        RGB-D (gray, metric depth); a chunk of one frame. Returns (poses
        [S], metrics [S])."""
        poses, metrics = self.track_chunk(self._prep(imgs1, 3, False)[None],
                                          self._prep(imgs2, 3, True)[None])
        return (tree_map(lambda x: x[0], poses),
                tree_map(lambda x: x[0], metrics))

    def track_chunk(self, imgs1, imgs2):
        """N frames for every stream: imgs [N, S, H, W]. The same result as
        N ``track`` calls; returns (poses [N, S], metrics [N, S])."""
        a, b = self._prep(imgs1, 4, False), self._prep(imgs2, 4, True)
        if a.shape != b.shape:
            raise ValueError(f"second-input chunk {tuple(b.shape)} != image "
                             f"chunk {tuple(a.shape)}")
        _, poses, metrics = multistream_chunk(
            self.states, a, b, self.config, self.runners,
            auto_reset=self.auto_reset, rgbd=self.rgbd)
        return poses, metrics

    @property
    def status(self) -> np.ndarray:
        """[S] int32 tracking state of each stream this rank holds (read
        from the device)."""
        return self.states.status.cpu().numpy()
