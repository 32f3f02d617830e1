"""lvt_tpu_torch — the PyTorch + CUDA port of lvt_tpu for NVIDIA Hopper.

The package mirrors lvt_tpu's layout (geometry/, core/, ops/, solver/) and
public names, and is held against it by tests/test_torch_*.py. Plain
tensor code is PyTorch; the three kernels of the stereo main path (score
maps, patch extraction, masked top-2) are hand-written CUDA C++ for sm_90a
in csrc/, built with nvcc at first use (lvt_tpu_torch.kernels). It imports
no JAX: only lvt_tpu's jax-free modules (config, io.synthetic).
"""

from lvt_tpu_torch import device as _device  # noqa: F401  (TF32 off at import)

__version__ = "0.1.0"
