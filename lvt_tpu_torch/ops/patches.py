"""Kernel P: the patch descriptor mode's per-keypoint work — BRIEF
descriptor and subpixel refinement of every keypoint slot.

Port of lvt_tpu/ops/patches_pallas.py (``extract_patches_batched``: the
32x32 smooth patch at (y - 15, x - 16) and the 8x8 raw-score patch at
(y - 3, x - 4) of each slot, zero for invalid slots) together with its
only consumer, ``brief.descriptors_from_patches`` and
``detect.subpixel_from_patches``. CUDA tensors go through the hand-written
kernel ``csrc/patches.cu``, which reads the 64 pool samples and 5 raw
scores of each slot from the maps, so the patch tensor never exists; CPU
tensors through :func:`describe_refine_plain`, the composition of
:func:`extract_patches_plain` (the counterpart of ``extract_patches_xla``)
with those two steps. The TPU kernel's span loads, rotates and lane phases
existed only for Mosaic's alignment rules and are not carried over.
"""

from __future__ import annotations

import torch

from lvt_tpu_torch import kernels
from lvt_tpu_torch.ops import brief, detect
from lvt_tpu_torch.ops.brief import PATCH, PATCH_C0, PATCH_R0

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


def window_index(x, y, size: int, r0: int, c0: int):
    """[B, K] coords -> [B, K, size, size] (rows, cols) of the windows whose
    top-left corner is (y - r0, x - c0), as int64 for advanced indexing."""
    off = torch.arange(size, device=x.device)
    rows = (y.long() - r0)[..., None, None] + off[:, None]     # [B, K, s, 1]
    cols = (x.long() - c0)[..., None, None] + off[None, :]     # [B, K, 1, s]
    return rows.expand(*x.shape, size, size), cols.expand(*x.shape, size, size)


def _windows(maps: torch.Tensor, x, y, size: int, r0: int, c0: int):
    """[B, H, W] maps, [B, K] coords -> [B, K, size, size] windows whose
    top-left corner is (y - r0, x - c0)."""
    b, h, w = maps.shape
    rows, cols = window_index(x, y, size, r0, c0)
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


def describe_refine_plain(smooth, raw, xc, yc, x, y, sel_valid, img_h, img_w):
    """Plain version of kernel P: patches, then BRIEF from the smooth
    patches and parabolic refinement from the raw ones."""
    patches, rawp = extract_patches_plain(smooth, raw, xc, yc, sel_valid)
    desc, valid = brief.descriptors_from_patches(patches, x, y, sel_valid,
                                                 img_h, img_w)
    xf, yf = detect.subpixel_from_patches(rawp, x, y)
    return desc, valid, torch.stack([xf, yf], dim=-1)


def describe_refine_batched(
    smooth: torch.Tensor,     # [B, H, W] f32 box sums (kernel A)
    raw: torch.Tensor,        # [B, H, W] f32 FAST scores (kernel A)
    xc: torch.Tensor,         # [B, K] int32 corner, pre-clamped (clamp_coords)
    yc: torch.Tensor,         # [B, K] int32
    x: torch.Tensor,          # [B, K] int32 corner as detected (unclamped)
    y: torch.Tensor,          # [B, K] int32
    sel_valid: torch.Tensor,  # [B, K] bool selected slots
    img_h: int,
    img_w: int,
):
    """-> (desc [B, K, 8] int32, valid [B, K] bool, kp [B, K, 2] f32).

    A slot is valid if it is selected and its corner lies BORDER px inside
    the image; invalid slots get a zero descriptor. kp is the corner
    refined to subpixel on the raw scores (unrefined for unselected slots).

    CUDA: ``csrc/patches.cu`` (replaces patches_pallas.py ``_patch_kernel``
    and the describe and refine steps that read its patches; one warp per
    slot loads the 64 pool samples into shared memory and packs each word
    with one ballot; ~1 MB of traffic at 2 x 1536 slots, so launch latency
    sets its time). CPU: the plain version."""
    if smooth.device.type == "cpu":
        return describe_refine_plain(smooth, raw, xc, yc, x, y, sel_valid,
                                     img_h, img_w)
    b, h, w = smooth.shape
    k = x.shape[1]
    if h < PATCH or w < PATCH:
        raise ValueError(f"maps {h}x{w} smaller than a {PATCH}x{PATCH} patch")
    dev = smooth.device
    kernels.require(smooth, "smooth", torch.float32, (b, h, w), dev)
    kernels.require(raw, "raw", torch.float32, (b, h, w), dev)
    for t, name in ((xc, "xc"), (yc, "yc"), (x, "x"), (y, "y")):
        kernels.require(t, name, torch.int32, (b, k), dev)
    kernels.require(sel_valid, "sel_valid", torch.bool, (b, k), dev)
    desc = torch.empty((b, k, brief.N_BITS // 32), dtype=torch.int32,
                       device=dev)
    valid = torch.empty((b, k), dtype=torch.bool, device=dev)
    kp = torch.empty((b, k, 2), dtype=torch.float32, device=dev)
    err = kernels.lib().lvt_describe_refine(
        smooth.data_ptr(), raw.data_ptr(), xc.data_ptr(), yc.data_ptr(),
        x.data_ptr(), y.data_ptr(), sel_valid.data_ptr(), desc.data_ptr(),
        valid.data_ptr(), kp.data_ptr(), b, h, w, k, int(img_h), int(img_w),
        kernels.stream_ptr(smooth))
    kernels.check(err, "describe_refine")
    describe_refine_batched.launches += 1
    return desc, valid, kp


describe_refine_batched.launches = 0
