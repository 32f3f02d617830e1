"""Convert state between lvt_tpu's pytrees (as numpy) and the port's
containers.

Both packages use NamedTuples with the same class and field names, so a
tree converts node by node: :func:`to_port` builds the port's class of the
same name from any such tree (lvt_tpu's, or the port's own with numpy
leaves); :func:`to_numpy` gives the port's tree with numpy leaves in
lvt_tpu's dtypes. Descriptors are the one dtype change: lvt_tpu's uint32
words are the port's int32 words with the same bits (``np.view``). bool,
int32 and f32 keep their dtypes. Leaves convert whole, so a batched state
(every leaf with a leading stream axis: lvt_tpu's
``batched_initial_state`` or multi-stream state, the port's
``parallel.multistream`` states) crosses the same way.

:func:`shard_state` cuts a whole state into one rank's block as the
sharded modes hold it (parallel/sharded_stream.py, parallel/stream_point.py),
by lvt_tpu's PartitionSpecs (``axes_of``); :func:`gather_state` puts the
blocks back together.
"""

from __future__ import annotations

import numpy as np
import torch

from lvt_tpu_torch.core.features import FrameFeatures
from lvt_tpu_torch.core.motion import MotionState
from lvt_tpu_torch.core.state import ObsWindow, PointStore, StepMetrics, VOState
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.tree import is_node, tree_map

_PORT_TYPES = {cls.__name__: cls for cls in (
    Pose, MotionState, FrameFeatures, PointStore, ObsWindow, VOState,
    StepMetrics)}


def to_port(tree, device):
    """A NamedTuple tree with array leaves -> the port's tree of tensors."""
    if is_node(tree):
        cls = _PORT_TYPES[type(tree).__name__]
        return cls(*(to_port(child, device) for child in tree))
    a = np.asarray(tree)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)


def to_numpy(tree, _field: str = ""):
    """The port's tree -> the same tree with numpy leaves, descriptors as
    uint32 (lvt_tpu's dtype)."""
    if is_node(tree):
        return type(tree)(*(to_numpy(child, name)
                            for name, child in zip(tree._fields, tree)))
    a = tree.detach().cpu().numpy()
    return a.view(np.uint32) if _field == "desc" else a


def axes_of(specs, axis: str):
    """From a tree of specs (``sharded_stream.state_specs``: per leaf a
    tuple naming the mesh axis that splits each leading dimension), the
    dimension of each leaf that ``axis`` splits, or None."""
    return tree_map(lambda spec: spec.index(axis) if axis in spec else None,
                    specs)


def shard_state(tree, rank: int, n: int, *, axis_of, device):
    """Rank ``rank``'s block of a whole state split over ``n`` ranks: each
    leaf cut into ``n`` contiguous blocks along its dimension in
    ``axis_of`` (a tree of int or None, :func:`axes_of`; None leaves stay
    whole), as ``P(axis)`` lays out lvt_tpu's shards. ``tree`` has array
    (or CPU tensor) leaves; returns the port's tree on ``device``. A state
    split over two mesh axes is cut twice: by one axis on the CPU, then by
    the other."""
    def cut(a, dim):
        a = np.asarray(a)
        if dim is None:
            return a
        if a.shape[dim] % n:
            raise ValueError(f"dimension {dim} of a {a.shape} leaf does not "
                             f"split into {n} blocks")
        return np.split(a, n, axis=dim)[rank]

    return to_port(tree_map(cut, tree, axis_of), device)


def gather_state(shards, *, axis_of):
    """The inverse of :func:`shard_state`: the ranks' blocks (port trees,
    in rank order) joined along their split dimensions; leaves that are not
    split are taken from rank 0. Returns the tree with numpy leaves in
    lvt_tpu's dtypes (:func:`to_numpy`)."""
    blocks = [to_numpy(s) for s in shards]

    def join(dim, *leaves):
        return leaves[0] if dim is None else np.concatenate(leaves, axis=dim)

    return tree_map(join, axis_of, *blocks)
