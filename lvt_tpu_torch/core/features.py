"""Fixed-capacity per-frame feature container. Port of
lvt_tpu/core/features.py; descriptors are int32 words (see device.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from lvt_tpu_torch.device import DESC_DTYPE

DESC_WORDS = 8  # 256-bit BRIEF descriptors as 8 x 32-bit words


class FrameFeatures(NamedTuple):
    """Detected keypoints + descriptors of one image, padded to capacity K."""

    kp: torch.Tensor     # [K, 2] float32 pixel positions (x, y)
    desc: torch.Tensor   # [K, DESC_WORDS] int32 packed BRIEF bits
    score: torch.Tensor  # [K] float32 detector response
    depth: torch.Tensor  # [K] float32 per-keypoint depth (RGB-D), else 0
    valid: torch.Tensor  # [K] bool

    def count(self) -> torch.Tensor:
        return torch.sum(self.valid, dim=-1)

    @staticmethod
    def empty(capacity: int, device=None) -> "FrameFeatures":
        return FrameFeatures(
            kp=torch.zeros((capacity, 2), dtype=torch.float32, device=device),
            desc=torch.zeros((capacity, DESC_WORDS), dtype=DESC_DTYPE,
                             device=device),
            score=torch.zeros((capacity,), dtype=torch.float32, device=device),
            depth=torch.zeros((capacity,), dtype=torch.float32, device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )
