"""Corner detection: FAST-9/16 score map, 3x3 NMS, per-cell top-k.

Port of lvt_tpu/ops/detect.py: ``fast_score_map``, ``nms3x3``,
``select_corners`` (subpixel refinement on the raw map for the dense
descriptor mode, the "scatter" gather) and ``subpixel_from_patches`` (patch
mode). The two maps come from kernel A (ops/perception.py), whose plain
version is built from these.

Tie order (lvt_tpu's ``approx_max_k`` returns the lowest index first among
equal scores, ``torch.topk`` does not): :func:`top_k_lowest_index_first`
ranks packed int64 keys (score bits << 32 | reversed index), which are
unique, so the selection is deterministic and equal to JAX's.

Extraction selects through the custom op ``lvt_tpu_torch::select_corners``
(:func:`select_slots`, one call for all images of a frame): the selection,
its padding to the slot capacity and kernel P's clamped corners (patch
mode) or the subpixel refinement on the raw map (the dense and sparse
modes), written straight into the slot buffers the next stage reads. Built
as kernel T's op (ops/top2.py): CUDA tensors launch the hand-written kernel
of ``csrc/select.cu`` once; CPU tensors take the plain version
(:func:`select_corners_plain`, the torch ops extraction ran before); a fake
kernel gives the shapes, and a vmap rule folds vmap's axis into the image
axis.
"""

from __future__ import annotations

import ctypes
import functools
import sys
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from lvt_tpu_torch import kernels
from lvt_tpu_torch.ops.brief import PATCH, PATCH_C0, PATCH_R0


# Bresenham circle of radius 3 (dx, dy), the FAST-9/16 ring, clockwise.
RING_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1),
    (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1),
    (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
BORDER = 3


def _arc9(ds, op):
    """op over each circular 9-arc of the 16 ring values, by doubling
    windows 2 -> 4 -> 8 -> 9."""
    b2 = [op(ds[k], ds[(k + 1) % 16]) for k in range(16)]
    b4 = [op(b2[k], b2[(k + 2) % 16]) for k in range(16)]
    b8 = [op(b4[k], b4[(k + 4) % 16]) for k in range(16)]
    return [op(b8[k], ds[(k + 8) % 16]) for k in range(16)]


def _reduce(xs, op):
    out = xs[0]
    for x in xs[1:]:
        out = op(out, x)
    return out


def fast_score_map(imgs: torch.Tensor) -> torch.Tensor:
    """FAST-9/16 max-threshold score of [B, H, W] frames: the largest t for
    which 9 contiguous ring pixels are all brighter than p + t (or darker
    than p - t), clamped >= 0 and zero within BORDER of the edge. uint8
    frames score in int32 (exact); other dtypes in f32."""
    b, h, w = imgs.shape
    a = imgs.to(torch.int32) if imgs.dtype == torch.uint8 else imgs.float()
    p = F.pad(a, (BORDER, BORDER, BORDER, BORDER))
    diffs = [p[:, BORDER + dy:BORDER + dy + h, BORDER + dx:BORDER + dx + w] - a
             for dx, dy in RING_OFFSETS]
    bright = _reduce(_arc9(diffs, torch.minimum), torch.maximum)
    dark = -_reduce(_arc9(diffs, torch.maximum), torch.minimum)
    score = torch.clamp(torch.maximum(bright, dark), min=0)
    ys = torch.arange(h, device=imgs.device)[:, None]
    xs = torch.arange(w, device=imgs.device)[None, :]
    interior = ((ys >= BORDER) & (ys < h - BORDER)
                & (xs >= BORDER) & (xs < w - BORDER))
    return torch.where(interior, score, torch.zeros_like(score))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Plateau-collapsing 3x3 non-max suppression of [B, H, W] scores: a
    pixel survives if it is strictly above its earlier neighbours (above,
    left) and at least its later ones (right, below); outside the image
    counts as the dtype's lowest value."""
    b, h, w = score.shape
    low = (-float("inf") if score.dtype.is_floating_point
           else torch.iinfo(score.dtype).min)
    sp = F.pad(score, (1, 1, 1, 1), value=low)

    def neigh(dy, dx):
        return sp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    before = torch.maximum(torch.maximum(neigh(-1, -1), neigh(-1, 0)),
                           torch.maximum(neigh(-1, 1), neigh(0, -1)))
    after = torch.maximum(torch.maximum(neigh(0, 1), neigh(1, -1)),
                          torch.maximum(neigh(1, 0), neigh(1, 1)))
    return torch.where((score > before) & (score >= after), score,
                       torch.zeros_like(score))


class Detections(NamedTuple):
    kp: torch.Tensor      # [B, N, 2] f32 (x, y) integer corner positions
    score: torch.Tensor   # [B, N] f32
    valid: torch.Tensor   # [B, N] bool
    count: torch.Tensor   # [B] int64
    threshold_used: torch.Tensor  # [B] f32 (after the low-corner fallback)
    kp_int: torch.Tensor  # [B, N, 2] int32 detected corner


def _bitrev8(v: torch.Tensor) -> torch.Tensor:
    v = v & 0xFF
    v = ((v & 0x55) << 1) | ((v >> 1) & 0x55)
    v = ((v & 0x33) << 2) | ((v >> 2) & 0x33)
    return ((v & 0x0F) << 4) | ((v >> 4) & 0x0F)


def _dither_at(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plateau tie-break at integer positions: van der Corput bit reversal
    per axis, quantised to multiples of 2^-15 (score + dither is exact in
    f32 for integer scores < 512)."""
    key = _bitrev8(y) * 128 + (_bitrev8(x) >> 1)
    return key.float() * (2.0 ** -15)


def _plateau_dither(h: int, w: int, device) -> torch.Tensor:
    return _dither_at(torch.arange(h, dtype=torch.int32, device=device)[:, None],
                      torch.arange(w, dtype=torch.int32, device=device)[None, :])


def _cell_geometry(h: int, w: int, cell_size: int):
    s_x = min(cell_size, w)
    s_y = min(cell_size, h)
    return s_y, s_x, -(-h // s_y), -(-w // s_x)


def _parab_offset(sm, s0, sp):
    """Parabolic 3-point peak offset in [-0.5, 0.5]."""
    denom = sm - 2.0 * s0 + sp
    small = torch.abs(denom) < 1e-6
    off = 0.5 * (sm - sp) / torch.where(small, 1e-6, denom)
    return torch.clamp(torch.where(small, 0.0, off), -0.5, 0.5)


def subpixel_from_patches(rawp: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Subpixel refinement from [..., K, 8, 8] raw-score patches (corner at
    (3, 4)) -> (x f32, y f32)."""
    sc = rawp[..., 3, 4]
    dx = _parab_offset(rawp[..., 3, 3], sc, rawp[..., 3, 5])
    dy = _parab_offset(rawp[..., 2, 4], sc, rawp[..., 4, 4])
    return x.float() + dx, y.float() + dy


def _subpixel_refine(score_raw: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Parabolic refinement of corners [B, K] on the raw score map
    [B, H, W] (lvt_tpu's ``_subpixel_refine``, the "scatter" gather) ->
    (x f32, y f32)."""
    b, h, w = score_raw.shape
    xc = torch.clamp(x, 1, w - 2).to(torch.int64)
    yc = torch.clamp(y, 1, h - 2).to(torch.int64)
    flat = score_raw.reshape(b, h * w)
    base = yc * w + xc

    def at(offset):
        return torch.gather(flat, 1, base + offset)

    sc = at(0)
    dx = _parab_offset(at(-1), sc, at(1))
    dy = _parab_offset(at(-w), sc, at(w))
    return x.float() + dx, y.float() + dy


def packed_keys(vals: torch.Tensor) -> torch.Tensor:
    """The unique int64 key of each f32 value along the last axis: the
    order-preserving integer image of its bits above the reversed index,
    so that keys descend as values do, equal values by ascending index."""
    n = vals.shape[-1]
    bits = (vals + 0.0).view(torch.int32)   # + 0.0 folds -0.0 into +0.0
    # order-preserving map of f32 bits onto signed integers
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    rev = (n - 1) - torch.arange(n, dtype=torch.int64, device=vals.device)
    return (bits << 32) | rev


def top_k_lowest_index_first(vals: torch.Tensor, k: int):
    """Top-k along the last axis of an f32 tensor, descending, equal values
    ordered by ascending index (lax.top_k / approx_max_k order).
    Returns (values, indices int64)."""
    n = vals.shape[-1]
    top = torch.topk(packed_keys(vals), k, dim=-1, largest=True,
                     sorted=True).values
    idx = (n - 1) - (top & 0xFFFFFFFF)
    return torch.gather(vals, -1, idx), idx


def cell_values(score: torch.Tensor, h: int, w: int, cell_size: int,
                spread_ties: bool) -> torch.Tensor:
    """The [B, cells, cell pixels] values that selection ranks: the map
    padded with zeros to the cell grid (cropped to it where larger), plus
    the plateau dither with ``spread_ties``, cell by cell in row-major
    order."""
    bsz = score.shape[0]
    s_y, s_x, ncy, ncx = _cell_geometry(h, w, cell_size)
    gy, gx = ncy * s_y, ncx * s_x
    sp = score[:, :min(gy, score.shape[1]), :min(gx, score.shape[2])]
    sp = F.pad(sp, (0, gx - sp.shape[2], 0, gy - sp.shape[1]))
    if spread_ties:
        sp = sp + _plateau_dither(gy, gx, score.device)
    cells = sp.reshape(bsz, ncy, s_y, ncx, s_x).permute(0, 1, 3, 2, 4)
    return cells.reshape(bsz, ncy * ncx, s_y * s_x)


def select_corners(
    score: torch.Tensor,   # [B, H', W'] NMS'd score map (H' >= h, W' >= w)
    threshold,
    *,
    cell_size: int,
    max_per_cell: int,
    corners_low_threshold: int = 200,
    img_hw: tuple[int, int] | None = None,
    spread_ties: bool,
    score_raw: torch.Tensor | None = None,
) -> Detections:
    """Adaptive threshold + per-cell top-k selection, batched over images.

    Output is cell-major, score-descending within a cell. ``spread_ties``
    adds the plateau dither (integer score maps only: uint8 frames); it
    has no default on purpose — take it from the frame dtype. Given the raw
    score map [B, H, W], ``kp`` is refined on it to subpixel positions
    (lvt_tpu's ``subpixel=True``); else ``kp`` is the integer corner."""
    bsz = score.shape[0]
    h, w = img_hw if img_hw is not None else score.shape[1:]
    s_y, s_x, ncy, ncx = _cell_geometry(h, w, cell_size)
    cells = cell_values(score, h, w, cell_size, spread_ties)

    top_keys, flat_idx = top_k_lowest_index_first(cells, max_per_cell)
    cell_ids = torch.arange(ncy * ncx, device=score.device)[:, None]
    y2 = (cell_ids // ncx) * s_y + flat_idx // s_x
    x2 = (cell_ids % ncx) * s_x + flat_idx % s_x
    top_scores = top_keys - _dither_at(y2, x2) if spread_ties else top_keys
    y = y2.reshape(bsz, -1)
    x = x2.reshape(bsz, -1)
    top_scores = top_scores.reshape(bsz, -1)

    t, t_low = _thresholds(threshold)
    use_low = (top_scores > t).sum(dim=-1) < corners_low_threshold
    t_eff = torch.where(use_low, t_low, t)                   # [B] f32
    valid = top_scores > t_eff[:, None]

    xi = torch.clamp(x, max=w - 1)
    yi = torch.clamp(y, max=h - 1)
    kp_int = torch.stack([xi, yi], dim=-1).to(torch.int32)
    if score_raw is None:
        kp = kp_int.float()
    else:
        kp = torch.stack(_subpixel_refine(score_raw, xi, yi), dim=-1)
    return Detections(
        kp=kp, score=top_scores, valid=valid,
        count=valid.sum(dim=-1), threshold_used=t_eff, kp_int=kp_int,
    )



def pad_to(arr: torch.Tensor, capacity: int, axis: int = 0) -> torch.Tensor:
    """``arr`` padded with zeros along ``axis`` to ``capacity`` (lvt_tpu's
    extract ``_pad_to``)."""
    n = arr.shape[axis]
    if n == capacity:
        return arr
    assert n < capacity, f"detector output {n} exceeds capacity {capacity}"
    shape = list(arr.shape)
    shape[axis] = capacity - n
    return torch.cat([arr, arr.new_zeros(shape)], dim=axis)


def _thresholds(threshold) -> tuple[float, float]:
    """(t, t_low) as float32 values: the threshold and the low-corner
    fallback's floor(t * 0.5 + 0.5), rounded as lvt_tpu rounds them."""
    t = np.float32(threshold)
    return float(t), float(np.floor(t * np.float32(0.5) + np.float32(0.5)))


def select_corners_plain(nms, raw, planes, threshold: float, cell_size: int,
                         max_per_cell: int, corners_low_threshold: int,
                         spread_ties: bool, capacity: int) -> tuple:
    """The plain version of ``lvt_tpu_torch::select_corners`` on [B, H, W]
    maps: :func:`select_corners` at the maps' extent, each output padded
    with zeros to ``capacity`` slots, and kernel P's clamped corners
    (``patches.clamp_coords``). Returns (xi, yi, xc, yc [B, capacity]
    int32, score f32, valid bool, kp, corner [B, capacity, 2] f32, desc
    [B, capacity, 8] int32, desc_valid [B, capacity] bool); with an empty
    ``raw`` (patch mode) kp and corner are [B, 0, 2], else kp is the
    corner refined on ``raw`` and corner the integer corner; with kernel
    B's ``planes`` [B, 8, H, W] (dense mode; else empty) desc and
    desc_valid are ``brief.descriptors_from_planes`` at the corners, else
    [B, 0, 8] and [B, 0]."""
    from lvt_tpu_torch.ops import brief
    from lvt_tpu_torch.ops.patches import clamp_coords

    b, h, w = nms.shape
    subpixel = raw.numel() > 0
    det = select_corners(nms, threshold, cell_size=cell_size,
                         max_per_cell=max_per_cell,
                         corners_low_threshold=corners_low_threshold,
                         img_hw=(h, w), spread_ties=spread_ties,
                         score_raw=raw if subpixel else None)

    def pad(a):
        return pad_to(a, capacity, axis=1)

    xi = pad(det.kp_int[..., 0]).contiguous()
    yi = pad(det.kp_int[..., 1]).contiguous()
    xc, yc = clamp_coords(xi, yi, h, w)
    if subpixel:
        kp, corner = pad(det.kp), pad(det.kp_int.float())
    else:
        kp, corner = nms.new_zeros((b, 0, 2)), nms.new_zeros((b, 0, 2))
    valid = pad(det.valid)
    if planes.numel() > 0:
        desc, desc_valid = brief.descriptors_from_planes(planes, corner, valid)
        desc = desc.contiguous()
    else:
        desc = xi.new_zeros((b, 0, brief.N_BITS // 32))
        desc_valid = valid.new_zeros((b, 0))
    return (xi, yi, xc, yc, pad(det.score), valid, kp, corner, desc,
            desc_valid)


@functools.lru_cache(maxsize=None)
def select_threads(device: int, batch: int, h: int, w: int, cell_size: int,
                   max_per_cell: int, capacity: int) -> int:
    """Threads a block of ``csrc/select.cu``'s launch takes on CUDA device
    ``device``: 512 where the card runs all the launch's clusters at once
    with blocks of 512 (cudaOccupancyMaxActiveClusters), else 256 (fewer
    registers a block, so more clusters at once). Asked once per shape, in
    the first (eager) frame, before any capture."""
    with torch.cuda.device(device):
        geo = (ctypes.c_int * 7)()
        kernels.lib().lvt_select_geometry(h, w, cell_size, max_per_cell,
                                          capacity, geo)
        fit = kernels.lib().lvt_select_max_clusters(
            batch, h, w, cell_size, max_per_cell, capacity, geo[6])
    return geo[6] if batch * geo[0] <= fit else geo[6] // 2


@torch.library.custom_op("lvt_tpu_torch::select_corners", mutates_args=(),
                         device_types="cuda")
def select_corners_op(nms: torch.Tensor, raw: torch.Tensor,
                      planes: torch.Tensor, threshold: float, cell_size: int,
                      max_per_cell: int, corners_low_threshold: int,
                      spread_ties: bool, capacity: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """B images: the NMS map [B, H, W] f32, the raw score map [B, H, W]
    (empty: patch mode) and kernel B's planes [B, 8, H, W] int32 (empty:
    not the dense mode) -> :func:`select_corners_plain`'s outputs.

    CUDA: one launch of ``csrc/select.cu``'s ``select_corners_kernel``,
    a thread-block cluster per cell (grid (blocks per cell, cells,
    images)): each block holds a range of the cell's rows in shared
    memory, the cluster finds the cell's ``max_per_cell``-th largest value
    by a radix select over distributed shared memory and writes the
    cell's slots, the last cell of an image applies the low-corner
    fallback (its two counters per image are a scratch the wrapper
    allocates and the launch zeroes); blocks of ``select_threads``. With
    the planes each slot's 8 descriptor words are read from them at its
    corner as the slot is written, and the fallback's pass zeroes those of
    the slots that end invalid or within the border."""
    b, h, w = nms.shape
    dev = nms.device
    kernels.require(nms, "nms", torch.float32, (b, h, w), dev)
    subpixel = raw.numel() > 0
    if subpixel:
        kernels.require(raw, "raw", torch.float32, (b, h, w), dev)
    dense = planes.numel() > 0
    if dense:
        if not subpixel:
            raise ValueError("select_corners: the planes' descriptors need "
                             "the raw map's corners")
        kernels.require(planes, "planes", torch.int32, (b, 8, h, w), dev)
    geo = (ctypes.c_int * 7)()
    if kernels.lib().lvt_select_geometry(h, w, cell_size, max_per_cell,
                                         capacity, geo):
        s_y, s_x = min(cell_size, h), min(cell_size, w)
        raise ValueError(
            f"select_corners: cells of {s_y}x{s_x} px keeping "
            f"{max_per_cell} each in {capacity} slots exceed the kernel's "
            f"bounds (csrc/select.cu): at most {max_per_cell} per cell of "
            f"{s_y * s_x} px, {geo[0]} cells x {max_per_cell} within the "
            f"{capacity} slots, and a cluster of at most {geo[1]} blocks "
            f"holding a cell's rows, {geo[3]} px a block here where one may "
            f"hold {geo[5]} at this max_per_cell")
    counters = torch.empty((2 * b,), dtype=torch.int32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    outs = (*(torch.empty((b, capacity), **i32) for _ in range(4)),
            torch.empty((b, capacity), dtype=torch.float32, device=dev),
            torch.empty((b, capacity), dtype=torch.bool, device=dev),
            *(torch.empty((b, capacity if subpixel else 0, 2),
                          dtype=torch.float32, device=dev)
              for _ in range(2)),
            torch.empty((b, capacity if dense else 0, 8), **i32),
            torch.empty((b, capacity if dense else 0), dtype=torch.bool,
                        device=dev))
    t, t_low = _thresholds(threshold)
    threads = select_threads(dev.index, b, h, w, cell_size, max_per_cell,
                             capacity)
    err = kernels.lib().lvt_select_corners(
        nms.data_ptr(), raw.data_ptr() if subpixel else None, b, h, w,
        cell_size, max_per_cell, capacity, threads, t, t_low,
        int(corners_low_threshold), int(spread_ties), PATCH_C0,
        w - PATCH + PATCH_C0, PATCH_R0, h - PATCH + PATCH_R0,
        planes.data_ptr() if dense else None, counters.data_ptr(),
        *(x.data_ptr() for x in outs[:6]),
        *((x.data_ptr() if subpixel else None) for x in outs[6:8]),
        *((x.data_ptr() if dense else None) for x in outs[8:]),
        kernels.stream_ptr(nms))
    kernels.check(err, "select_corners")
    select_slots.launches += 1
    return outs


def _select_corners_fake(nms, raw, planes, threshold, cell_size,
                         max_per_cell, corners_low_threshold, spread_ties,
                         capacity):
    b = nms.shape[0]
    n_kp = capacity if raw.numel() > 0 else 0
    n_desc = capacity if planes.numel() > 0 else 0
    return (*(nms.new_empty((b, capacity), dtype=torch.int32)
              for _ in range(4)),
            nms.new_empty((b, capacity)),
            nms.new_empty((b, capacity), dtype=torch.bool),
            nms.new_empty((b, n_kp, 2)), nms.new_empty((b, n_kp, 2)),
            nms.new_empty((b, n_desc, 8), dtype=torch.int32),
            nms.new_empty((b, n_desc), dtype=torch.bool))


kernels.register_stream_op(sys.modules[__name__], "select_corners",
                           select_corners_plain, _select_corners_fake, 3)


def select_slots(nms: torch.Tensor, threshold, *, cell_size: int,
                 max_per_cell: int, corners_low_threshold: int,
                 spread_ties: bool, capacity: int,
                 score_raw: torch.Tensor | None = None,
                 planes: torch.Tensor | None = None) -> tuple:
    """Per-cell selection on [B, H, W] maps into ``capacity`` slots per
    image (the op ``lvt_tpu_torch::select_corners``; ``score_raw`` given:
    the subpixel refinement on it; ``planes`` given, kernel B's: each
    slot's descriptor from them). CPU tensors take the plain version,
    CUDA tensors the kernel (any other device raises); under
    ``torch.func.vmap`` one launch serves every image."""
    if nms.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nms: expected a CUDA tensor, got {nms.device}")
    raw = nms.new_zeros((0,)) if score_raw is None else score_raw
    planes = (nms.new_zeros((0,), dtype=torch.int32) if planes is None
              else planes)
    return select_corners_op(nms, raw, planes, float(threshold),
                             int(cell_size), int(max_per_cell),
                             int(corners_low_threshold), bool(spread_ties),
                             int(capacity))


select_slots.launches = 0
