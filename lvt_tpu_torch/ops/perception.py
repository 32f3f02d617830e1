"""Kernel A: 9x9 box sum, FAST-9/16 score and plateau-collapsing 3x3 NMS;
kernel B: dense BRIEF bit planes of A's box sum.

Port of lvt_tpu/ops/perception_pallas.py (``_score_smooth_kernel`` through
``perception_patch_maps_batched``, and ``_brief_kernel`` through
``perception_maps_batched``). CUDA tensors go through the hand-written
kernels ``csrc/perception.cu`` and ``csrc/brief.cu``; CPU tensors through
:func:`perception_plain` and :func:`brief_planes_plain`, the same
arithmetic in plain torch ops.

Semantics, both versions:
  * the image is zero-padded (the Pallas wrapper's ``jnp.pad``);
  * smooth = 9x9 box *sum*, rows +d then -d, then columns +d then -d —
    the kernel's summation order, which matters only for float frames;
  * raw = FAST-9/16 max-threshold score: max over the 16 circular 9-arcs
    of the min ring difference, bright and dark, clamped >= 0, zeroed
    outside the 3-px interior of the image;
  * nms = raw where it is strictly above its above/left neighbours and
    >= its right/below ones, else 0.
uint8 frames compute in int32, so all three maps are exact integers and
bit-equal to JAX; float frames compute in f32. Unlike the TPU kernel the
outputs are not padded to a tile grid: they are [B, H, W].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lvt_tpu_torch import kernels
from lvt_tpu_torch.device import DESC_DTYPE
from lvt_tpu_torch.ops import brief, detect

_R = 4       # box-sum radius (9x9)


def box_sum(imgs: torch.Tensor) -> torch.Tensor:
    """Zero-padded 9x9 box sum of [B, H, W] frames: rows +d then -d, then
    columns +d then -d, as the kernel sums. uint8 frames sum in int32."""
    b, h, w = imgs.shape
    a = imgs.to(torch.int32) if imgs.dtype == torch.uint8 else imgs.float()
    p = F.pad(a, (_R, _R, _R, _R))
    rsum = p[:, _R:_R + h, :]
    for d in range(1, _R + 1):
        rsum = rsum + p[:, _R + d:_R + d + h, :]
        rsum = rsum + p[:, _R - d:_R - d + h, :]
    smooth = rsum[:, :, _R:_R + w]
    for d in range(1, _R + 1):
        smooth = smooth + rsum[:, :, _R + d:_R + d + w]
        smooth = smooth + rsum[:, :, _R - d:_R - d + w]
    return smooth


def perception_plain(imgs: torch.Tensor):
    """Plain-torch kernel A: imgs [B, H, W] uint8 or f32 ->
    (nms, raw, smooth), each [B, H, W] f32."""
    raw = detect.fast_score_map(imgs)
    return (detect.nms3x3(raw).float(), raw.float(), box_sum(imgs).float())


def perception_patch_maps_batched(imgs: torch.Tensor):
    """imgs [B, H, W] uint8 or f32 -> (nms, raw, smooth) [B, H, W] f32.

    CUDA: ``csrc/perception.cu`` (replaces perception_pallas.py
    ``_score_smooth_kernel``; uint8 frames: one block per 64x32 output
    tile, two pixels per register in 16-bit lanes, the FAST arc test on
    Hopper's DPX 3-input min/max, so it needs sm_90; float frames: one f32
    pixel per thread; bound by device-memory traffic: 1 byte in and 12
    bytes out per pixel). CPU: the plain version.
    """
    if imgs.device.type == "cpu":
        return perception_plain(imgs)
    if imgs.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"imgs: dtype {imgs.dtype}, expected uint8 or float32")
    kernels.require(imgs, "imgs", imgs.dtype)
    if imgs.dim() != 3:
        raise ValueError(f"imgs: expected [B, H, W], got {tuple(imgs.shape)}")
    b, h, w = imgs.shape
    out = torch.empty((3, b, h, w), dtype=torch.float32, device=imgs.device)
    nms, raw, smooth = out[0], out[1], out[2]
    err = kernels.lib().lvt_perception(
        imgs.data_ptr(), int(imgs.dtype == torch.uint8), nms.data_ptr(),
        raw.data_ptr(), smooth.data_ptr(), b, h, w, kernels.stream_ptr(imgs))
    kernels.check(err, "perception")
    perception_patch_maps_batched.launches += 1
    return nms, raw, smooth


perception_patch_maps_batched.launches = 0


def brief_planes_plain(smooth: torch.Tensor) -> torch.Tensor:
    """Plain-torch kernel B: smooth [B, H, W] f32 -> planes [B, 8, H, W]
    int32."""
    return brief.dense_descriptor_planes(smooth)


def brief_planes(smooth: torch.Tensor) -> torch.Tensor:
    """Kernel B: dense BRIEF-256 bit planes of kernel A's ``smooth``
    [B, H, W] f32 -> [B, 8, H, W] int32 (lvt_tpu's uint32 bits), samples
    zero outside the image.

    CUDA: ``csrc/brief.cu`` (replaces perception_pallas.py
    ``_brief_kernel``; two pixels per thread, a 64x32 tile plus the
    pattern's reach staged twice in shared memory, once shifted by a
    column, the pattern compiled in). CPU: the plain version.
    Only comparisons, so both are bit-exact for any input. Unlike the TPU
    kernel, which reads kernel A's tile padding past the right edge, every
    sample outside the image is zero; no valid descriptor (BORDER = 20)
    reads there.
    """
    if smooth.device.type == "cpu":
        return brief_planes_plain(smooth)
    kernels.require(smooth, "smooth", torch.float32)
    if smooth.dim() != 3:
        raise ValueError(f"smooth: expected [B, H, W], got {tuple(smooth.shape)}")
    b, h, w = smooth.shape
    planes = torch.empty((b, brief.N_BITS // 32, h, w), dtype=DESC_DTYPE,
                         device=smooth.device)
    err = kernels.lib().lvt_brief_planes(smooth.data_ptr(), planes.data_ptr(),
                                         b, h, w, kernels.stream_ptr(smooth))
    kernels.check(err, "brief_planes")
    brief_planes.launches += 1
    return planes


brief_planes.launches = 0


def perception_maps_batched(imgs: torch.Tensor):
    """Dense descriptor mode: imgs [B, H, W] uint8 or f32 -> (raw, nms
    [B, H, W] f32, planes [B, 8, H, W] int32): kernel A, then kernel B on
    A's zero-padded ``smooth`` (perception_pallas.perception_maps_batched)."""
    nms, raw, smooth = perception_patch_maps_batched(imgs)
    return raw, nms, brief_planes(smooth)
