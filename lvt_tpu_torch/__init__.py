"""lvt_tpu_torch — the PyTorch + CUDA port of lvt_tpu for NVIDIA Hopper.

The package mirrors lvt_tpu's layout (geometry/, core/, ops/, solver/) and
public names, and is held against it by tests/test_torch_*.py. Plain
tensor code is PyTorch; the kernels (score maps, dense BRIEF planes,
describe + refine at the keypoints, Hamming masked top-2) are hand-written
CUDA C++ for sm_90a in csrc/, built with nvcc at first use
(lvt_tpu_torch.kernels). It stands on its own: it imports neither JAX nor
anything of lvt_tpu, and keeps its own copies of the configuration
(config.py, configs/) and the synthetic world (io/synthetic.py).
"""

from lvt_tpu_torch import device as _device  # noqa: F401  (TF32 off at import)

__version__ = "0.1.0"
