"""Local-map maintenance as masked fixed-shape tensor ops.

Port of lvt_tpu/core/map.py: insertion is a masked scatter into free
slots, culling clears validity bits."""

from __future__ import annotations

from typing import NamedTuple

import torch

from lvt_tpu_torch.core.state import PointStore
from lvt_tpu_torch.ops.collectives import por_if
from lvt_tpu_torch.ops.hamming import claim_mask


class InsertResult(NamedTuple):
    store: PointStore
    n_inserted: torch.Tensor
    n_dropped: torch.Tensor
    taken: torch.Tensor   # [capacity] bool: slots (re)populated this call


def insert_points(store: PointStore, new_pos, new_desc, insert_mask,
                  new_counter=None, new_age=None) -> InsertResult:
    """Fill free slots, in slot order, with the masked new points in input
    order (compacted by a stable sort); overflow is dropped."""
    k = insert_mask.shape[0]
    if new_counter is None:
        new_counter = torch.zeros(k, dtype=torch.int32, device=new_pos.device)
    if new_age is None:
        new_age = torch.zeros(k, dtype=torch.int32, device=new_pos.device)
    order = torch.argsort((~insert_mask).to(torch.uint8), stable=True)
    n_new = insert_mask.sum()
    free = ~store.valid
    free_rank = torch.cumsum(free, dim=0) - 1
    take = free & (free_rank < n_new) & (free_rank < k)
    src = order[torch.clamp(free_rank, 0, k - 1)]
    new_store = PointStore(
        pos=torch.where(take[:, None], new_pos[src], store.pos),
        desc=torch.where(take[:, None], new_desc[src], store.desc),
        counter=torch.where(take, new_counter[src], store.counter),
        age=torch.where(take, new_age[src], store.age),
        valid=store.valid | take,
    )
    n_inserted = take.sum()
    return InsertResult(new_store, n_inserted, n_new - n_inserted, take)


def apply_match_bookkeeping(store: PointStore, match_idx) -> PointStore:
    """invisible or unmatched -> counter += 1; matched -> age += 1."""
    failed = store.valid & (match_idx < 0)
    matched = store.valid & (match_idx >= 0)
    return store._replace(counter=store.counter + failed.to(torch.int32),
                          age=store.age + matched.to(torch.int32))


def clean_untracked(store: PointStore, match_idx, feature_matched,
                    untracked_threshold: int, group=None):
    """Drop points with counter >= threshold and un-mark the feature each
    dropped point matched this frame. Returns (store, feature_matched).
    With ``group`` (the store is one rank's block), the un-mark mask is
    OR-reduced across the group, so every rank sees the same marks."""
    k = feature_matched.shape[0]
    remove = store.valid & (store.counter >= untracked_threshold)
    unmark = por_if(claim_mask(torch.where(remove, match_idx, -1), k), group)
    return store._replace(valid=store.valid & ~remove), feature_matched & ~unmark
