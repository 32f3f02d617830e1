"""Per-keypoint patch extraction (the patch descriptor mode's gather).

Port of lvt_tpu/ops/patches_pallas.py. For every keypoint slot it copies
the 32x32 smooth patch at (y - 15, x - 16) and the 8x8 raw-score patch at
(y - 3, x - 4); invalid slots come back zero. CUDA tensors go through the
hand-written kernel ``csrc/patches.cu``; CPU tensors through
:func:`extract_patches_plain`, the counterpart of ``extract_patches_xla``.
The TPU kernel's span loads, rotates and lane phases existed only for
Mosaic's alignment rules and are not carried over.
"""

from __future__ import annotations

import torch

from lvt_tpu_torch import kernels

PATCH = 32        # smooth patch extent; pool offsets live in [-15, 15]
PATCH_R0 = 15     # pool sample (dx, dy) maps to patch row PATCH_R0 + dy
PATCH_C0 = 16     # ... and patch col PATCH_C0 + dx
RAWP = 8          # raw-score patch extent (3x3 subpixel neighbourhood + pad)
RAWP_R0 = 3       # the corner sits at raw patch (RAWP_R0, RAWP_C0)
RAWP_C0 = 4


def clamp_coords(x: torch.Tensor, y: torch.Tensor, hp: int, wp: int):
    """Clamp integer keypoint coords so both patch reads stay inside the
    [hp, wp] maps. Keypoints that can be valid (20 px BRIEF border) never
    move; other slots read in-bounds garbage that validity masks."""
    x = torch.clamp(x, PATCH_C0, wp - PATCH + PATCH_C0)
    y = torch.clamp(y, PATCH_R0, hp - PATCH + PATCH_R0)
    return x, y


def _windows(maps: torch.Tensor, x, y, size: int, r0: int, c0: int):
    """[B, H, W] maps, [B, K] coords -> [B, K, size, size] windows whose
    top-left corner is (y - r0, x - c0)."""
    b, h, w = maps.shape
    off = torch.arange(size, device=maps.device)
    rows = (y.long() - r0)[..., None, None] + off[:, None]     # [B, K, s, 1]
    cols = (x.long() - c0)[..., None, None] + off[None, :]     # [B, K, 1, s]
    flat = (rows * w + cols).reshape(b, -1)
    return torch.gather(maps.reshape(b, h * w), 1, flat).reshape(
        b, x.shape[1], size, size)


def extract_patches_plain(smooth, raw, x, y, valid):
    """Plain-torch patch extraction (extract_patches_xla's semantics); the
    coords are clamped again, as the kernel does, so no read leaves the
    maps."""
    x, y = clamp_coords(x, y, smooth.shape[1], smooth.shape[2])
    patches = _windows(smooth.float(), x, y, PATCH, PATCH_R0, PATCH_C0)
    rawp = _windows(raw.float(), x, y, RAWP, RAWP_R0, RAWP_C0)
    v = valid[..., None, None]
    return (torch.where(v, patches, torch.zeros_like(patches)),
            torch.where(v, rawp, torch.zeros_like(rawp)))


def extract_patches_batched(
    smooth: torch.Tensor,   # [B, H, W] f32
    raw: torch.Tensor,      # [B, H, W] f32
    x: torch.Tensor,        # [B, K] int32, pre-clamped (clamp_coords)
    y: torch.Tensor,        # [B, K] int32
    valid: torch.Tensor,    # [B, K] bool; invalid slots come back zero
):
    """-> ([B, K, 32, 32] smooth patches, [B, K, 8, 8] raw patches).

    CUDA: ``csrc/patches.cu`` (replaces patches_pallas.py
    ``_patch_kernel``; one warp per keypoint, one lane per patch column, so
    each patch row is one coalesced 128-byte read and write; bound by
    device-memory traffic, ~4.3 KB written per slot). CPU: the plain
    version."""
    if smooth.device.type == "cpu":
        return extract_patches_plain(smooth, raw, x, y, valid)
    b, h, w = smooth.shape
    k = x.shape[1]
    if h < PATCH or w < PATCH:
        raise ValueError(f"maps {h}x{w} smaller than a {PATCH}x{PATCH} patch")
    dev = smooth.device
    kernels.require(smooth, "smooth", torch.float32, (b, h, w), dev)
    kernels.require(raw, "raw", torch.float32, (b, h, w), dev)
    kernels.require(x, "x", torch.int32, (b, k), dev)
    kernels.require(y, "y", torch.int32, (b, k), dev)
    kernels.require(valid, "valid", torch.bool, (b, k), dev)
    patches = torch.empty((b, k, PATCH, PATCH), dtype=torch.float32, device=dev)
    rawp = torch.empty((b, k, RAWP, RAWP), dtype=torch.float32, device=dev)
    err = kernels.lib().lvt_extract_patches(
        smooth.data_ptr(), raw.data_ptr(), x.data_ptr(), y.data_ptr(),
        valid.data_ptr(), patches.data_ptr(), rawp.data_ptr(), b, h, w, k,
        kernels.stream_ptr(smooth))
    kernels.check(err, "extract_patches")
    extract_patches_batched.launches += 1
    return patches, rawp


extract_patches_batched.launches = 0
