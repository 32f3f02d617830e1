"""BRIEF-256 binary descriptors: from per-keypoint patches (patch mode),
from dense bit planes of every pixel (dense mode), or sampled from the box
sums at caller-supplied corners (external corners).

Port of lvt_tpu/ops/brief.py. The pattern — 256 comparison pairs over a
pool of 64 Gaussian sample points — is regenerated here in numpy from the
same seeds, so it is bit-identical to ``lvt_tpu.ops.brief.test_pattern()``
without importing JAX.

Where the JAX package samples the pool with one-hot matmuls at
``Precision.HIGHEST``, the port indexes: the 64 pool values are a gather
from the flattened 32x32 patch, and the 256 bits compare two gathers of
those. That is exact by construction — no matmul, so no TF32 risk.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

PATCH = 32        # smooth patch extent; pool offsets live in [-15, 15]
PATCH_R0 = 15     # pool sample (dx, dy) maps to patch row PATCH_R0 + dy
PATCH_C0 = 16     # ... and patch col PATCH_C0 + dx
KERNEL_SIZE = 9
N_BITS = 256
POOL_SIZE = 64
BORDER = PATCH // 2 + KERNEL_SIZE // 2  # 20
_HALF = PATCH // 2 - 1                  # pattern offsets lie in [-15, 15]
_PATTERN_SEED = 0x5F3759DF


@functools.lru_cache(maxsize=1)
def sample_pool() -> np.ndarray:
    """[POOL_SIZE, 2] int32 (dx, dy) distinct sample offsets."""
    rs = np.random.RandomState(_PATTERN_SEED)
    sigma = PATCH / 5.0
    half = PATCH // 2 - 1
    pts: list[tuple[int, int]] = []
    seen = set()
    while len(pts) < POOL_SIZE:
        cand = np.clip(np.round(rs.randn(2) * sigma), -half, half).astype(int)
        key = (int(cand[0]), int(cand[1]))
        if key not in seen:
            seen.add(key)
            pts.append(key)
    return np.array(pts, np.int32)


@functools.lru_cache(maxsize=1)
def pair_indices() -> np.ndarray:
    """[N_BITS, 2] int32 (i, j) pool indices; bit = S(p_i) < S(p_j)."""
    rs = np.random.RandomState(_PATTERN_SEED ^ 0xA5A5A5)
    pairs: list[tuple[int, int]] = []
    seen = set()
    while len(pairs) < N_BITS:
        i, j = rs.randint(0, POOL_SIZE, 2)
        if i != j and (i, j) not in seen and (j, i) not in seen:
            seen.add((i, j))
            pairs.append((int(i), int(j)))
    return np.array(pairs, np.int32)


@functools.lru_cache(maxsize=1)
def test_pattern() -> np.ndarray:
    """[256, 2, 2] int32 (pair, point, (dx, dy)) sampling offsets."""
    return sample_pool()[pair_indices()]


@functools.lru_cache(maxsize=None)
def _pattern_tensors(device: torch.device):
    """(pool index into a flattened 32x32 patch [64] and pair endpoints
    [256] x 2 as long tensors, bit shifts [32] int32, pool offsets (dx, dy)
    [64, 2] long) on ``device``, uploaded once."""
    pool = sample_pool()
    flat = (PATCH_R0 + pool[:, 1]) * PATCH + (PATCH_C0 + pool[:, 0])
    pairs = pair_indices()
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return (as_t(flat), as_t(pairs[:, 0]), as_t(pairs[:, 1]),
            torch.arange(32, dtype=torch.int32, device=device), as_t(pool))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 256] bool -> [..., 8] int32 words, bit i of word w = bits[32w+i]
    (bit 31 sets the sign, so the words hold lvt_tpu's uint32 bits)."""
    shifts = _pattern_tensors(bits.device)[3]
    words = bits.reshape(*bits.shape[:-1], 8, 32).to(torch.int32) << shifts
    while words.shape[-1] > 1:   # OR the 32 shifted bits together, 5 halvings
        half = words.shape[-1] // 2
        words = words[..., :half] | words[..., half:]
    return words[..., 0]


def descriptors_from_patches(
    patches: torch.Tensor,   # [..., K, PATCH, PATCH] f32 smooth patches
    x: torch.Tensor,         # [..., K] int32 original (unclamped) column
    y: torch.Tensor,         # [..., K] int32 ... row
    kp_valid: torch.Tensor,  # [..., K] bool
    img_h: int,
    img_w: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """BRIEF-256 from per-keypoint smooth patches -> (desc [..., K, 8]
    int32, valid [..., K]); keypoints within BORDER of the image edge are
    invalid and their descriptor is zero."""
    pool_idx, p0, p1, _, _ = _pattern_tensors(patches.device)
    vals = patches.reshape(*patches.shape[:-2], PATCH * PATCH)[..., pool_idx]
    desc = pack_bits(vals[..., p0] < vals[..., p1])
    inside = ((x >= BORDER) & (x < img_w - BORDER)
              & (y >= BORDER) & (y < img_h - BORDER))
    valid = kp_valid & inside
    return torch.where(valid[..., None], desc, 0), valid


def dense_descriptor_planes(smooth: torch.Tensor) -> torch.Tensor:
    """Packed BRIEF bit planes of EVERY pixel: smooth [B, H, W] f32 ->
    [B, 8, H, W] int32, bit i of word w = s[pi] < s[pj] for pair 32w + i,
    the 64 pool samples read zero outside the image. The plain version of
    kernel B (ops/perception.py)."""
    b, h, w = smooth.shape
    pad = _HALF + 1
    sp = F.pad(smooth, (pad, pad, pad, pad))
    samples = [sp[:, pad + dy:pad + dy + h, pad + dx:pad + dx + w]
               for dx, dy in sample_pool().tolist()]
    pairs = pair_indices().tolist()
    words = []
    for word in range(N_BITS // 32):
        acc = torch.zeros((b, h, w), dtype=torch.int32, device=smooth.device)
        for i in range(32):
            pi, pj = pairs[32 * word + i]
            acc |= (samples[pi] < samples[pj]).to(torch.int32) << i
        words.append(acc)
    return torch.stack(words, dim=1)


def descriptors_from_planes(
    planes: torch.Tensor,    # [B, 8, H, W] int32 packed bit planes
    kp: torch.Tensor,        # [B, K, 2] f32 (x, y)
    kp_valid: torch.Tensor,  # [B, K] bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-keypoint descriptors gathered from dense bit planes -> (desc
    [B, K, 8] int32, valid [B, K]); keypoints within BORDER of the image
    edge are invalid and their descriptor is zero."""
    b, words, h, w = planes.shape
    x = torch.round(kp[..., 0]).to(torch.int64)
    y = torch.round(kp[..., 1]).to(torch.int64)
    inside = (x >= BORDER) & (x < w - BORDER) & (y >= BORDER) & (y < h - BORDER)
    valid = kp_valid & inside
    flat = torch.clamp(y, 0, h - 1) * w + torch.clamp(x, 0, w - 1)   # [B, K]
    desc = torch.gather(planes.reshape(b, words, h * w), 2,
                        flat[:, None, :].expand(b, words, flat.shape[1]))
    return torch.where(valid[..., None], desc.transpose(1, 2), 0), valid


def box_smooth(img: torch.Tensor, size: int = KERNEL_SIZE) -> torch.Tensor:
    """Separable box *sum* over a size x size window of img [..., H, W],
    edge-replicated, float32 (lvt_tpu's ``box_smooth``): along each axis a
    cumulative sum of the padded line, differenced ``size`` apart. The
    cumulative sums are taken in float64 and rounded to float32, as torch's
    CPU cumsum of float32 accumulates, so the card sums as the CPU does. On
    integer-valued frames every sum is an exact integer below 2^24, equal to
    lvt_tpu's whatever the order; on non-integer frames XLA's float32
    cumsum rounds otherwise (tests/test_torch_external_corners.py states
    the gap)."""
    r = size // 2

    def along(a, dim):
        n = a.shape[dim]
        idx = torch.clamp(torch.arange(-r - 1, n + r, device=a.device), 0,
                          n - 1)
        c = torch.cumsum(a.index_select(dim, idx).double(), dim).float()
        return c.narrow(dim, size, n) - c.narrow(dim, 0, n)

    return along(along(img.float(), -2), -1)


def descriptors_sparse(
    smooth: torch.Tensor,    # [..., H, W] f32 box sums
    kp: torch.Tensor,        # [..., K, 2] f32 (x, y)
    kp_valid: torch.Tensor,  # [..., K] bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """BRIEF-256 at each keypoint from the box sums, with one gather of the
    64 pool samples per keypoint -> (desc [..., K, 8] int32, valid [..., K]).
    The keypoint is rounded half to even; one within BORDER of the edge is
    invalid and its descriptor zero, and every keypoint is clamped so its
    samples index inside the image. Bit-equal to lvt_tpu's on the same
    box sums."""
    h, w = smooth.shape[-2:]
    x = torch.round(kp[..., 0]).to(torch.int64)
    y = torch.round(kp[..., 1]).to(torch.int64)
    inside = (x >= BORDER) & (x < w - BORDER) & (y >= BORDER) & (y < h - BORDER)
    valid = kp_valid & inside
    xc = torch.clamp(x, _HALF + 1, w - _HALF - 2)
    yc = torch.clamp(y, _HALF + 1, h - _HALF - 2)
    _, p0, p1, _, pool = _pattern_tensors(smooth.device)
    idx = ((yc[..., None] + pool[:, 1]) * w + (xc[..., None] + pool[:, 0]))
    flat = smooth.reshape(*smooth.shape[:-2], h * w)
    vals = torch.gather(flat, -1, idx.flatten(-2)).reshape(idx.shape)
    desc = pack_bits(vals[..., p0] < vals[..., p1])
    return torch.where(valid[..., None], desc, 0), valid


def compute_descriptors(img: torch.Tensor, kp: torch.Tensor,
                        kp_valid: torch.Tensor):
    """img [..., H, W] (uint8 or float), keypoints [..., K, 2] -> (desc
    [..., K, 8] int32, valid [..., K] with the border removed)."""
    return descriptors_sparse(box_smooth(img), kp, kp_valid)
