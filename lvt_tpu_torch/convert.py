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
"""

from __future__ import annotations

import numpy as np
import torch

from lvt_tpu_torch.core.features import FrameFeatures
from lvt_tpu_torch.core.motion import MotionState
from lvt_tpu_torch.core.state import ObsWindow, PointStore, StepMetrics, VOState
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.tree import is_node

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
