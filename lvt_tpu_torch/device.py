"""Device and dtype policy of the port.

* Every public entry point takes an explicit ``device``; nothing here
  picks the CPU because no GPU was found — asking for CUDA without one
  raises.
* Geometry and solver math is fp32. TF32 is switched off for matmuls and
  cuDNN at import, so no float32 product silently keeps ~3 digits.
  (Triangulation emulates f32 fused multiply-adds in float64: see
  ops/triangulate.py.)
* Descriptors are 8 ``int32`` words holding the same bits as lvt_tpu's
  ``uint32`` words (torch has no popcount, and uint32 ``>>`` is missing
  on the CPU); ``lvt_tpu_torch.convert`` views them back for checkpoints.
* The card and the CPU round alike: short sums are written out in a fixed
  order instead of a matmul or reduction, and a constant divisor is a
  device scalar (:func:`scalar`).
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DESC_DTYPE = torch.int32


def scalar(c: float, like: torch.Tensor) -> torch.Tensor:
    """c as a 0-d tensor on ``like``'s device, to divide by. ``x / c`` with
    a Python number c multiplies by the rounded reciprocal 1 / c on CUDA,
    which can differ from the CPU's correctly rounded quotient in the last
    bit; ``x / scalar(c, x)`` divides on both."""
    return torch.full((), c, dtype=like.dtype, device=like.device)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA request without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False (this PyTorch build or machine has no CUDA device)")
    return dev


def upload(x, device: torch.device) -> torch.Tensor:
    """``x`` (an array or a tensor) on ``device``. A host array bound for a
    CUDA device is staged in pinned memory and copied without blocking the
    host, so the upload is no host sync (the caching host allocator keeps
    the pinned block until the copy has run). A read-only array (a view of
    a message buffer) is copied first: torch takes no read-only memory."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()
    t = torch.as_tensor(x)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
