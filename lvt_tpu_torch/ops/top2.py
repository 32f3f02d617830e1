"""Masked top-2 over a Hamming matrix under radius or row-window masks.

Port of lvt_tpu/ops/top2_pallas.py (``masked_dual_top2``). CUDA tensors go
through the hand-written kernel ``csrc/top2.cu``; CPU tensors through
:func:`masked_dual_top2_plain`, which materialises the candidate masks and
runs ``hamming.masked_top2_int`` — the XLA path of ops/matching.py.
"""

from __future__ import annotations

import torch

from lvt_tpu_torch import kernels
from lvt_tpu_torch.ops import hamming

COL_BITS = 11
MAX_K = 1 << COL_BITS   # keys are d << 11 | col, so K <= 2048
_MODES = {"dual": 0, "single": 1, "row": 2}


def _masks(q_meta, q_valid, t_meta, t_valid, r2a, r2b, row_mode):
    base = q_valid[:, None] & t_valid[None, :]
    if row_mode:
        y_r = t_meta[:, 1]
        m = base & (y_r[None, :] >= q_meta[:, 0:1]) & (y_r[None, :] <= q_meta[:, 1:2])
        return m, m
    diff = t_meta[None, :, :] - q_meta[:, None, :]
    dr2 = (diff * diff).sum(dim=-1)
    ma = base & (dr2 < r2a)
    return ma, (ma if r2b == r2a else base & (dr2 < r2b))


def masked_dual_top2_plain(dist, q_meta, q_valid, t_meta, t_valid, *,
                           r2a: float, r2b: float, row_mode: bool = False):
    ma, mb = _masks(q_meta, q_valid, t_meta, t_valid, r2a, r2b, row_mode)
    out_a = hamming.masked_top2_int(dist, ma)
    out_b = out_a if mb is ma else hamming.masked_top2_int(dist, mb)
    return out_a, out_b


def masked_dual_top2(
    dist: torch.Tensor,     # [M, K] int32 distances (values <= 256)
    q_meta: torch.Tensor,   # [M, 2] f32 query coords, or (lo, hi) in row mode
    q_valid: torch.Tensor,  # [M] bool
    t_meta: torch.Tensor,   # [K, 2] f32 target coords
    t_valid: torch.Tensor,  # [K] bool
    *,
    r2a: float,
    r2b: float,
    row_mode: bool = False,
):
    """((d1, d2, best, n_cand) under r2a, the same under r2b); d1/d2 f32,
    best/n_cand int64, each [M]. Single-radius callers pass r2b == r2a;
    row mode ignores both radii.

    CUDA: ``csrc/top2.cu`` (replaces top2_pallas.py ``_top2_kernel``; one
    warp per query row, register-resident running top-2 and a shuffle
    merge; bound by reading the [M, K] matrix once). CPU: the plain
    version."""
    if dist.device.type == "cpu":
        return masked_dual_top2_plain(dist, q_meta, q_valid, t_meta, t_valid,
                                      r2a=r2a, r2b=r2b, row_mode=row_mode)
    m, k = dist.shape
    if k > MAX_K:
        raise ValueError(f"K={k} exceeds the key packing bound {MAX_K}")
    dev = dist.device
    kernels.require(dist, "dist", torch.int32, (m, k), dev)
    kernels.require(q_meta, "q_meta", torch.float32, (m, 2), dev)
    kernels.require(q_valid, "q_valid", torch.bool, (m,), dev)
    kernels.require(t_meta, "t_meta", torch.float32, (k, 2), dev)
    kernels.require(t_valid, "t_valid", torch.bool, (k,), dev)
    mode = "row" if row_mode else ("single" if r2b == r2a else "dual")
    fout = torch.empty((2, 2, m), dtype=torch.float32, device=dev)
    iout = torch.empty((2, 2, m), dtype=torch.int64, device=dev)
    err = kernels.lib().lvt_masked_dual_top2(
        dist.data_ptr(), q_meta.data_ptr(), q_valid.data_ptr(),
        t_meta.data_ptr(), t_valid.data_ptr(), m, k, float(r2a), float(r2b),
        _MODES[mode], fout.data_ptr(), iout.data_ptr(), kernels.stream_ptr(dist))
    kernels.check(err, "masked_dual_top2")
    masked_dual_top2.launches += 1
    return ((fout[0, 0], fout[1, 0], iout[0, 0], iout[1, 0]),
            (fout[0, 1], fout[1, 1], iout[0, 1], iout[1, 1]))


masked_dual_top2.launches = 0
