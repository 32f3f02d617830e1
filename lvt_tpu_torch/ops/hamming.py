"""Bit-packed binary descriptors and dense masked Hamming matching.

Port of lvt_tpu/ops/hamming.py (the one-to-one resolution also sharded,
over a process group). Descriptors are 8 int32 words holding the
bits of lvt_tpu's uint32 words; the distance is XOR plus a SWAR popcount
written so that no int32 operation overflows (torch has no popcount op).
"""

from __future__ import annotations

import torch

from lvt_tpu_torch.ops.collectives import axis_index, axis_size, pmin_if

DESC_WORDS = 8
BIG = 1.0e9
_IMAX = torch.iinfo(torch.int32).max


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each int32 element (all 32 bits, sign bit included).

    The sign bit is counted apart, so the SWAR steps work on a value in
    [0, 2^31) and no intermediate leaves the int32 range."""
    sign = (x >> 31) & 1
    v = x & 0x7FFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return (v & 0x3F) + sign


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., N, W] int32, b [..., K, W] int32 -> [..., N, K] int32
    Hamming distances."""
    x = a[..., :, None, :] ^ b[..., None, :, :]
    return popcount32(x).sum(dim=-1, dtype=torch.int32)


def masked_top2_int(dist: torch.Tensor, cand_mask: torch.Tensor):
    """Per-row best/second distances among masked candidates of an integer
    distance matrix, via packed keys d * K + col (lowest column wins ties).
    Returns (d1 f32, d2 f32, best int64, n_cand int64), each [Q] (or
    [..., Q] for [..., Q, K] inputs)."""
    k = dist.shape[-1]
    col = torch.arange(k, dtype=torch.int32, device=dist.device)
    key = torch.where(cand_mask, dist.to(torch.int32) * k + col,
                      torch.full_like(dist, _IMAX, dtype=torch.int32))
    k1 = key.amin(dim=-1)
    k2 = torch.where(key == k1[..., None], _IMAX, key).amin(dim=-1)
    has1 = k1 != _IMAX
    has2 = k2 != _IMAX
    d1 = torch.where(has1, (k1 // k).float(), BIG)
    d2 = torch.where(has2, (k2 // k).float(), BIG)
    best = torch.where(has1, k1 % k, 0).long()
    n_cand = cand_mask.sum(dim=-1)
    return d1, d2, best, n_cand


def accept_matches(d1, d2, best, n_cand, ratio_threshold, abs_threshold):
    """Reference acceptance rule -> match index per query, -1 if rejected."""
    ok_ratio = (n_cand >= 2) & (d1 < ratio_threshold * d2)
    ok_single = (n_cand == 1) & (d1 <= abs_threshold)
    return torch.where(ok_ratio | ok_single, best, -1)


def resolve_one_to_one(match_idx: torch.Tensor, d1: torch.Tensor,
                       num_targets: int, group=None) -> torch.Tensor:
    """Every target keeps only the query with the smallest distance (ties
    to the lower query index); losers get -1.

    With ``group`` (the queries are map points sharded over its ranks, in
    contiguous blocks), the query index is the global one, ``axis_index *
    q + arange(q)``, and the per-target minimum a ``pmin`` over the group,
    so every rank sees the same winner."""
    q = match_idx.shape[0]
    valid = match_idx >= 0
    qid = axis_index(group) * q + torch.arange(q, dtype=torch.int32,
                                                device=match_idx.device)
    # unique ordering key: distance (<= 256) then query index; rejected
    # queries (d1 may be BIG) are masked before the multiply
    key = (torch.where(valid, d1, 0.0).to(torch.int32)
           * (axis_size(group) * q + 1) + qid)
    key = torch.where(valid, key, _IMAX)
    tgt = torch.where(valid, match_idx, num_targets)
    best_key = torch.full((num_targets + 1,), _IMAX, dtype=torch.int32,
                          device=match_idx.device)
    best_key = pmin_if(best_key.scatter_reduce(0, tgt, key, "amin"), group)
    won = valid & (best_key[tgt] == key)
    return torch.where(won, match_idx, -1)


def claim_mask(idx: torch.Tensor, k: int) -> torch.Tensor:
    """[k] bool: True at every target index that ``idx`` (>= 0) names —
    the ``zeros(k + 1).at[where(idx >= 0, idx, k)].set(True)[:k]`` idiom."""
    slot = torch.where(idx >= 0, idx, k)
    marks = torch.zeros(k + 1, dtype=torch.bool, device=idx.device)
    return marks.index_fill(0, slot, True)[:k]
